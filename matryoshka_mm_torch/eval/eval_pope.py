"""POPE yes/no scorer (reference: llava/eval/eval_pope.py:5-90)."""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List


def normalize_answer(text: str) -> str:
    """First sentence, comma-stripped, mapped to yes/no."""
    if text.find(".") != -1:
        text = text.split(".")[0]
    text = text.replace(",", "")
    words = text.split(" ")
    if "No" in words or "not" in words or "no" in words:
        return "no"
    return "yes"


def eval_pope(answers: List[Dict], label_file: str) -> Dict[str, float]:
    label_list = [json.loads(q)["label"] for q in open(label_file)]

    preds = [0 if normalize_answer(a["text"]) == "no" else 1 for a in answers]
    labels = [0 if l == "no" else 1 for l in label_list]

    yes_ratio = preds.count(1) / len(preds)
    TP = sum(1 for p, l in zip(preds, labels) if p == 1 and l == 1)
    FP = sum(1 for p, l in zip(preds, labels) if p == 1 and l == 0)
    TN = sum(1 for p, l in zip(preds, labels) if p == 0 and l == 0)
    FN = sum(1 for p, l in zip(preds, labels) if p == 0 and l == 1)

    precision = TP / (TP + FP) if TP + FP else 0.0
    recall = TP / (TP + FN) if TP + FN else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    acc = (TP + TN) / (TP + TN + FP + FN)

    print("TP\tFP\tTN\tFN\t")
    print(f"{TP}\t{FP}\t{TN}\t{FN}")
    print(f"Accuracy: {acc}")
    print(f"Precision: {precision}")
    print(f"Recall: {recall}")
    print(f"F1 score: {f1}")
    print(f"Yes ratio: {yes_ratio}")
    print("%.3f, %.3f, %.3f, %.3f, %.3f" % (f1, acc, precision, recall, yes_ratio))
    return {"f1": f1, "accuracy": acc, "precision": precision,
            "recall": recall, "yes_ratio": yes_ratio}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--annotation-dir", type=str)
    parser.add_argument("--question-file", type=str)
    parser.add_argument("--result-file", type=str)
    args = parser.parse_args()

    questions = [json.loads(line) for line in open(args.question_file)]
    questions = {q["question_id"]: q for q in questions}
    answers = [json.loads(q) for q in open(args.result_file)]
    # chunked eval randomizes ordering; sort for stable per-category slices
    answers = sorted(answers, key=lambda x: x["question_id"])
    for file in os.listdir(args.annotation_dir):
        assert file.startswith("coco_pope_") and file.endswith(".json")
        category = file[10:-5]
        cur = [x for x in answers
               if questions[x["question_id"]]["category"] == category]
        print(f"Category: {category}, # samples: {len(cur)}")
        eval_pope(cur, os.path.join(args.annotation_dir, file))
        print("====================================")


if __name__ == "__main__":
    main()
