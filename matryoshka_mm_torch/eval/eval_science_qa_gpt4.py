"""ScienceQA scoring against GPT-4 answers, with optional requery merge.

Compact equivalent of the reference's two GPT-4 ScienceQA scorers
(reference: llava/eval/eval_science_qa_gpt4.py:1-103 and
eval_science_qa_gpt4_requery.py): answers are letter-extracted with the
"The answer is X." pattern, GPT-4 failures fall back to the model's own
answer, and ``--requery-result`` (the requery variant) overrides a
failed model answer with the requeried one before comparison.  Reports
accuracy, the model∪GPT-4 upper bound, and the GPT-4 no-answer rate.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
from collections import defaultdict

_PAT = re.compile(r"The answer is ([A-Z])\.")
OPTIONS = ["A", "B", "C", "D", "E"]


def extract_answer(text: str) -> str:
    found = _PAT.findall(text or "")
    return found[0] if len(found) == 1 else "FAILED"


def pred_idx(letter: str, choices, rng: random.Random) -> int:
    if letter in OPTIONS[: len(choices)]:
        return OPTIONS.index(letter)
    return rng.choice(range(len(choices)))


def evaluate(base_dir: str, gpt4_result: str, our_result: str,
             split: str = "test", requery_result: str = None,
             seed: int = 0) -> dict:
    rng = random.Random(seed)
    split_ids = json.load(open(os.path.join(base_dir, "pid_splits.json")))[split]
    problems = json.load(open(os.path.join(base_dir, "problems.json")))
    ours = {p["question_id"]: p
            for p in (json.loads(l) for l in open(our_result))}
    gpt4 = json.load(open(gpt4_result))["outputs"]
    requery = {}
    if requery_result:
        requery = {p["question_id"]: p
                   for p in (json.loads(l) for l in open(requery_result))}

    res = defaultdict(int)
    for pid in split_ids:
        if pid not in ours or pid not in gpt4 or pid not in problems:
            continue
        prob = problems[pid]
        our_ans = extract_answer(ours[pid]["text"])
        if our_ans == "FAILED" and pid in requery:
            our_ans = extract_answer(requery[pid]["text"])
            res["requeried"] += 1
        gpt4_ans = extract_answer(gpt4[pid])

        our_i = pred_idx(our_ans, prob["choices"], rng)
        gpt4_i = (our_i if gpt4_ans == "FAILED"
                  else pred_idx(gpt4_ans, prob["choices"], rng))
        if gpt4_ans == "FAILED":
            res["gpt4_failed"] += 1
        res["correct" if gpt4_i == prob["answer"] else "incorrect"] += 1
        if gpt4_i == prob["answer"] or our_i == prob["answer"]:
            res["correct_upperbound"] += 1
    return dict(res)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-dir", required=True)
    ap.add_argument("--gpt4-result", required=True)
    ap.add_argument("--our-result", required=True)
    ap.add_argument("--requery-result", default=None)
    ap.add_argument("--split", default="test")
    args = ap.parse_args()
    r = evaluate(args.base_dir, args.gpt4_result, args.our_result,
                 split=args.split, requery_result=args.requery_result)
    total = r.get("correct", 0) + r.get("incorrect", 0)
    if not total:
        print("no overlapping predictions")
        return
    print(f"Total: {total}, Correct: {r.get('correct', 0)}, "
          f"Accuracy: {r.get('correct', 0) / total * 100:.2f}%")
    print(f"Upper bound: {r.get('correct_upperbound', 0) / total * 100:.2f}%")
    print(f"GPT-4 NO-ANS: {r.get('gpt4_failed', 0)} "
          f"({r.get('gpt4_failed', 0) / total * 100:.2f}%), "
          f"requeried: {r.get('requeried', 0)}")


if __name__ == "__main__":
    main()
