"""TextVQA scorer.

Matches generated answers back to their annotations and scores them with
the EvalAI leave-one-out consensus metric (m4c_evaluator).  Answers are
keyed by (image_id, lowercased question); the question must first be
recovered from whichever prompt layout the generator used — behavior
contract with the reference CLI (llava/eval/eval_textvqa.py), structure
and parsing are this repo's own.

Recognized prompt layouts (a rule table, first match wins):

* few-shot OCR form:     "OCR tokens: ... Question: <q> Short answer:"
* 3-line reference-OCR:  question on line 2 if the prompt leads with
                         "Reference OCR token:", else line 1
* 2-line plain form:     question on line 1, instruction on line 2
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

from .m4c_evaluator import TextVQAAccuracyEvaluator

_FEWSHOT_RE = re.compile(r"Question: (.*?) Short answer:", re.DOTALL)


def _from_fewshot(prompt: str, lines: List[str]) -> Optional[str]:
    if not prompt.startswith("OCR tokens: "):
        return None
    m = _FEWSHOT_RE.search(prompt)
    return m.group(1) if m else None


def _from_ref_ocr(prompt: str, lines: List[str]) -> Optional[str]:
    if "Reference OCR token: " not in prompt or len(lines) != 3:
        return None
    return lines[1] if prompt.startswith("Reference OCR token:") else lines[0]


def _from_plain(prompt: str, lines: List[str]) -> Optional[str]:
    return lines[0] if len(lines) == 2 else None


_QUESTION_RULES = (_from_fewshot, _from_ref_ocr, _from_plain)


def question_from_prompt(prompt: str) -> str:
    """Recover the lowercased question text from a generator prompt."""
    lines = prompt.split("\n")
    for rule in _QUESTION_RULES:
        q = rule(prompt, lines)
        if q is not None:
            return q.lower()
    raise ValueError(f"unrecognized prompt format: {prompt!r}")


# CLI-compat alias (reference name)
prompt_processor = question_from_prompt


def score_textvqa(annotations: List[dict], answers: List[dict]) -> Dict[str, float]:
    """``annotations``: TextVQA 'data' records ({image_id, question,
    answers}); ``answers``: generator jsonl rows ({question_id, prompt,
    text}).  Returns {accuracy, samples}."""
    by_key = {(a["image_id"], a["question"].lower()): a["answers"]
              for a in annotations}
    pairs = [{"pred_answer": row["text"],
              "gt_answers": by_key[(row["question_id"],
                                    question_from_prompt(row["prompt"]))]}
             for row in answers]
    acc = TextVQAAccuracyEvaluator().eval_pred_list(pairs)
    return {"accuracy": acc, "samples": len(pairs)}


def eval_single(annotation_file: str, result_file: str) -> float:
    print(Path(result_file).stem)
    annotations = json.loads(Path(annotation_file).read_text())["data"]
    with open(result_file) as f:
        answers = [json.loads(line) for line in f]
    scores = score_textvqa(annotations, answers)
    print("Samples: {samples}\nAccuracy: {pct:.2f}%\n".format(
        samples=scores["samples"], pct=100.0 * scores["accuracy"]))
    return scores["accuracy"]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-file", type=str)
    parser.add_argument("--result-file", type=str)
    parser.add_argument("--result-dir", type=str)
    args = parser.parse_args()

    targets = []
    if args.result_file:
        targets.append(Path(args.result_file))
    if args.result_dir:
        for p in sorted(Path(args.result_dir).iterdir()):
            if p.suffix == ".jsonl":
                targets.append(p)
            else:
                print(f"Skipping {p.name}")
    for p in targets:
        eval_single(args.annotation_file, str(p))


if __name__ == "__main__":
    main()
