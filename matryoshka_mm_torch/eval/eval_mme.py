"""MME scorer.

The reference defers to MME's official calculation script; this implements
the same protocol locally: per-subtask accuracy (acc) and image-level
paired accuracy (acc+ — both questions about an image answered correctly),
score = 100*(acc + acc+), summed into Perception / Cognition totals.

Answers jsonl rows: {question_id: "<subtask>/<image>__<idx>" or with
separate fields, text: prediction}; annotation jsonl rows mirror the
generator input with {question_id, category, image, gt: yes|no}.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict

from .eval_pope import normalize_answer

PERCEPTION = ["existence", "count", "position", "color", "posters",
              "celebrity", "scene", "landmark", "artwork", "OCR"]
COGNITION = ["commonsense_reasoning", "numerical_calculation",
             "text_translation", "code_reasoning"]


def score_mme(annotations, answers) -> Dict[str, float]:
    """annotations/answers: lists of dicts keyed by question_id."""
    ans = {a["question_id"]: normalize_answer(a["text"]) for a in answers}

    per_cat_correct = defaultdict(int)
    per_cat_total = defaultdict(int)
    per_image = defaultdict(list)
    for q in annotations:
        cat = q["category"]
        gt = q["gt"].strip().lower()
        pred = ans.get(q["question_id"], "")
        ok = pred == gt
        per_cat_correct[cat] += int(ok)
        per_cat_total[cat] += 1
        per_image[(cat, q["image"])].append(ok)

    results = {}
    perception = cognition = 0.0
    for cat in per_cat_total:
        acc = per_cat_correct[cat] / per_cat_total[cat]
        plus = [all(v) for (c, _), v in per_image.items() if c == cat]
        acc_plus = sum(plus) / len(plus) if plus else 0.0
        score = 100.0 * (acc + acc_plus)
        results[cat] = round(score, 2)
        if cat in PERCEPTION:
            perception += score
        elif cat in COGNITION:
            cognition += score
    results["Perception_total"] = round(perception, 2)
    results["Cognition_total"] = round(cognition, 2)
    for k, v in sorted(results.items()):
        print(f"{k}: {v}")
    return results


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-file", required=True)
    parser.add_argument("--result-file", required=True)
    args = parser.parse_args()
    annotations = [json.loads(l) for l in open(args.annotation_file)]
    answers = [json.loads(l) for l in open(args.result_file)]
    score_mme(annotations, answers)


if __name__ == "__main__":
    main()
