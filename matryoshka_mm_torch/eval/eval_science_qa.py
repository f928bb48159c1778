"""ScienceQA scorer (reference: llava/eval/eval_science_qa.py:1-120)."""

from __future__ import annotations

import argparse
import json
import os
import re


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument("--base-dir", type=str)
    parser.add_argument("--result-file", type=str)
    parser.add_argument("--output-file", type=str)
    parser.add_argument("--output-result", type=str)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--options", type=list,
                        default=["A", "B", "C", "D", "E"])
    return parser.parse_args()


def get_pred_idx(prediction, choices, options):
    """'C' -> 2; unparseable -> -1."""
    if prediction in options[: len(choices)]:
        return options.index(prediction)
    return -1


def parse_answer(pred_text: str, options) -> str:
    if pred_text in options:
        return pred_text
    if len(pred_text) >= 3 and pred_text[0] in options and pred_text[1:3] == ". ":
        return pred_text[0]
    res = re.compile(r"The answer is ([A-Z]).").findall(pred_text)
    if len(res) == 1:
        return res[0]
    return "FAILED"


def evaluate(base_dir, result_file, split="test",
             options=("A", "B", "C", "D", "E")):
    options = list(options)
    split_indices = json.load(
        open(os.path.join(base_dir, "pid_splits.json")))[split]
    problems = json.load(open(os.path.join(base_dir, "problems.json")))
    predictions = [json.loads(line) for line in open(result_file)]
    predictions = {p["question_id"]: p for p in predictions}
    split_problems = {idx: problems[idx] for idx in split_indices}

    results = {"correct": [], "incorrect": []}
    sqa_results = {"acc": None, "correct": None, "count": None,
                   "results": {}, "outputs": {}}

    for prob_id, prob in split_problems.items():
        if prob_id not in predictions:
            pred = {"text": "FAILED", "prompt": "Unknown"}
            pred_text = "FAILED"
        else:
            pred = predictions[prob_id]
            pred_text = pred["text"]

        answer = parse_answer(pred_text, options)
        pred_idx = get_pred_idx(answer, prob["choices"], options)

        analysis = {
            "question_id": prob_id,
            "parsed_ans": answer,
            "ground_truth": options[prob["answer"]],
            "question": pred["prompt"],
            "pred": pred_text,
            "is_multimodal": "<image>" in pred["prompt"],
        }
        sqa_results["results"][prob_id] = pred_idx
        sqa_results["outputs"][prob_id] = pred_text
        (results["correct"] if pred_idx == prob["answer"]
         else results["incorrect"]).append(analysis)

    correct = len(results["correct"])
    total = correct + len(results["incorrect"])
    mm_correct = len([x for x in results["correct"] if x["is_multimodal"]])
    mm_total = mm_correct + len([x for x in results["incorrect"]
                                 if x["is_multimodal"]])
    print(f"Total: {total}, Correct: {correct}, "
          f"Accuracy: {correct / total * 100:.2f}%, "
          f"IMG-Accuracy: {mm_correct / max(mm_total, 1) * 100:.2f}%")

    sqa_results["acc"] = correct / total * 100
    sqa_results["acc_multimodal"] = mm_correct / max(mm_total, 1) * 100
    sqa_results["correct"] = correct
    sqa_results["count"] = total
    return results, sqa_results


def main():
    args = get_args()
    results, sqa_results = evaluate(args.base_dir, args.result_file,
                                    args.split, args.options)
    with open(args.output_file, "w") as f:
        json.dump(results, f, indent=2)
    with open(args.output_result, "w") as f:
        json.dump(sqa_results, f, indent=2)


if __name__ == "__main__":
    main()
