"""MM-Vet GPT-4 grader (reference: llava/eval/eval_mmvet.py:1-272).

Few-shot 0.0-1.0 grading per sample with retry and resume; judge is
pluggable (OpenAI-compatible endpoint in deployment, fake in tests).
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Callable, Dict, Optional

GRADER_PROMPT = """Compare the ground truth and prediction from AI models, to give a correctness score for the prediction. <AND> in the ground truth means it is totally right only when all elements in the ground truth are present in the prediction, and <OR> means it is totally right when any one element in the ground truth is present in the prediction. The correctness score is 0.0 (totally wrong), 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, or 1.0 (totally right). Just complete the last space of the correctness score.

Question | Ground truth | Prediction | Correctness
--- | --- | --- | ---
What is x in the equation? | -1 <AND> -5 | x = 3 | 0.0
What is x in the equation? | -1 <AND> -5 | x = -1 or 5 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -1 or x = -5 | 1.0
"""


def parse_grade(text: str) -> float:
    m = re.search(r"([01](?:\.\d+)?)\s*$", text.strip())
    if m:
        v = float(m.group(1))
        if 0.0 <= v <= 1.0:
            return v
    return 0.0


def grade_mmvet(results_file: str, meta_file: str, output_file: str,
                chat_fn: Optional[Callable] = None,
                limit: Optional[int] = None) -> Dict[str, float]:
    """results_file: {'v1_0': 'prediction', ...}; meta_file: MM-Vet json with
    per-id question/answer/capability."""
    if chat_fn is None:
        from .gpt_review import openai_chat_fn

        chat_fn = openai_chat_fn(model="gpt-4-0613", max_tokens=3)

    results = json.load(open(results_file))
    meta = json.load(open(meta_file))

    done = {}
    if os.path.exists(output_file):
        done = json.load(open(output_file))

    grades = dict(done)
    ids = list(meta.keys())[:limit]
    for qid in ids:
        if qid in grades:
            continue
        q = meta[qid]
        pred = results.get(qid, "")
        prompt = (GRADER_PROMPT +
                  f"{q['question']} | {q['answer']} | {pred} | ")
        grades[qid] = parse_grade(chat_fn("You are a grader.", prompt))
        with open(output_file, "w") as f:
            json.dump(grades, f, indent=2)

    # capability-grouped aggregation
    by_cap = {}
    for qid in ids:
        for cap in meta[qid].get("capability", ["all"]):
            by_cap.setdefault(cap, []).append(grades.get(qid, 0.0))
    summary = {cap: round(100 * sum(v) / len(v), 1) for cap, v in by_cap.items()}
    summary["total"] = round(
        100 * sum(grades.get(q, 0.0) for q in ids) / max(len(ids), 1), 1)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_file", required=True)
    parser.add_argument("--meta_file", required=True)
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args()
    grade_mmvet(args.results_file, args.meta_file, args.output_file,
                limit=args.limit)
