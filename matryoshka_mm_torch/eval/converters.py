"""Benchmark submission / eval-format converters.

One module covering the reference's converter scripts (reference:
llava/eval/convert_{gqa,vqav2,vizwiz,seed,mmbench,mmvet}_for_*.py), exposed
both as functions and as ``python -m ...converters <name> ...`` subcommands.
"""

from __future__ import annotations

import argparse
import json
import os

from .m4c_evaluator import EvalAIAnswerProcessor

SEED_TYPE_ID_TO_NAME = {
    1: "Scene Understanding", 2: "Instance Identity", 3: "Instance Attributes",
    4: "Instance Location", 5: "Instances Counting", 6: "Spatial Relation",
    7: "Instance Interaction", 8: "Visual Reasoning", 9: "Text Understanding",
    10: "Action Recognition", 11: "Action Prediction",
    12: "Procedure Understanding",
}


def convert_gqa_for_eval(src: str, dst: str) -> None:
    all_answers = []
    for line in open(src):
        res = json.loads(line)
        all_answers.append({"questionId": res["question_id"],
                            "prediction": res["text"].rstrip(".").lower()})
    with open(dst, "w") as f:
        json.dump(all_answers, f)


def convert_vqav2_for_submission(src: str, dst: str, test_split: str) -> None:
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    results, error_line = [], 0
    for line in open(src):
        try:
            results.append(json.loads(line))
        except Exception:
            error_line += 1
    results = {x["question_id"]: x["text"] for x in results}
    split = [json.loads(line) for line in open(test_split)]
    print(f"total results: {len(results)}, total split: {len(split)}, "
          f"error_line: {error_line}")
    processor = EvalAIAnswerProcessor()
    all_answers = [{"question_id": x["question_id"],
                    "answer": processor(results.get(x["question_id"], ""))}
                   for x in split]
    with open(dst, "w") as f:
        json.dump(all_answers, f)


def convert_vizwiz_for_submission(annotation_file: str, result_file: str,
                                  result_upload_file: str) -> None:
    os.makedirs(os.path.dirname(result_upload_file) or ".", exist_ok=True)
    results, error_line = [], 0
    for line in open(result_file):
        try:
            results.append(json.loads(line))
        except Exception:
            error_line += 1
    results = {x["question_id"]: x["text"] for x in results}
    split = [json.loads(line) for line in open(annotation_file)]
    print(f"total results: {len(results)}, total split: {len(split)}, "
          f"error_line: {error_line}")
    processor = EvalAIAnswerProcessor()
    all_answers = []
    for x in split:
        assert x["question_id"] in results
        all_answers.append({"image": x["image"],
                            "answer": processor(results[x["question_id"]])})
    with open(result_upload_file, "w") as f:
        json.dump(all_answers, f)


def convert_seed_for_submission(annotation_file: str, result_file: str,
                                result_upload_file: str) -> None:
    with open(annotation_file) as f:
        data = json.load(f)
    results = {}
    for line in open(result_file):
        row = json.loads(line)
        results[row["question_id"]] = row

    type_counts, correct_counts = {}, {}
    answers_upload = []
    for q in data["questions"]:
        data_type = q["question_type_id"]
        type_counts[data_type] = type_counts.get(data_type, 0) + 1
        try:
            qid = int(q["question_id"])
        except Exception:
            qid = q["question_id"]
        if qid not in results:
            correct_counts.setdefault(data_type, 0)
            continue
        row = results[qid]
        answers_upload.append({"question_id": str(qid),
                               "prediction": row["text"]})
        if row["text"] == q["answer"]:
            correct_counts[data_type] = correct_counts.get(data_type, 0) + 1

    total_count = total_correct = 0
    for data_type in sorted(type_counts):
        acc = correct_counts.get(data_type, 0) / type_counts[data_type] * 100
        name = SEED_TYPE_ID_TO_NAME.get(data_type, str(data_type))
        print(f"{name}: {acc:.2f}%")
        total_count += type_counts[data_type]
        total_correct += correct_counts.get(data_type, 0)
    print(f"Total accuracy: {total_correct / total_count * 100:.2f}%")

    with open(result_upload_file, "w") as f:
        json.dump(answers_upload, f)


def convert_mmbench_for_submission(annotation_file: str, result_dir: str,
                                   upload_dir: str, experiment: str) -> None:
    import pandas as pd

    df = pd.read_table(annotation_file)
    cur_df = df.copy()
    drop = [c for c in ("hint", "category", "source", "image", "comment",
                        "l2-category") if c in cur_df.columns]
    cur_df = cur_df.drop(columns=drop)
    cur_df.insert(min(6, len(cur_df.columns)), "prediction", None)
    for pred in open(os.path.join(result_dir, f"{experiment}.jsonl")):
        pred = json.loads(pred)
        cur_df.loc[df["index"] == pred["question_id"], "prediction"] = pred["text"]
    os.makedirs(upload_dir, exist_ok=True)
    out = os.path.join(upload_dir, f"{experiment}.xlsx")
    try:
        cur_df.to_excel(out, index=False, engine="openpyxl")
    except Exception:
        # openpyxl may be unavailable; fall back to tsv with same content
        out = os.path.join(upload_dir, f"{experiment}.tsv")
        cur_df.to_csv(out, sep="\t", index=False)
    print(f"wrote {out}")


def convert_mmvet_for_eval(src: str, dst: str) -> None:
    cur_result = {}
    for line in open(src):
        data = json.loads(line)
        qid = data["question_id"]
        cur_result[f"v1_{qid}"] = data["text"]
    with open(dst, "w") as f:
        json.dump(cur_result, f, indent=2)


def main():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("gqa")
    p.add_argument("--src"), p.add_argument("--dst")
    p = sub.add_parser("vqav2")
    p.add_argument("--src"), p.add_argument("--dst"), p.add_argument("--test_split")
    p = sub.add_parser("vizwiz")
    p.add_argument("--annotation-file"), p.add_argument("--result-file")
    p.add_argument("--result-upload-file")
    p = sub.add_parser("seed")
    p.add_argument("--annotation-file"), p.add_argument("--result-file")
    p.add_argument("--result-upload-file")
    p = sub.add_parser("mmbench")
    p.add_argument("--annotation-file"), p.add_argument("--result-dir")
    p.add_argument("--upload-dir"), p.add_argument("--experiment")
    p = sub.add_parser("mmvet")
    p.add_argument("--src"), p.add_argument("--dst")

    args = parser.parse_args()
    if args.cmd == "gqa":
        convert_gqa_for_eval(args.src, args.dst)
    elif args.cmd == "vqav2":
        convert_vqav2_for_submission(args.src, args.dst, args.test_split)
    elif args.cmd == "vizwiz":
        convert_vizwiz_for_submission(args.annotation_file, args.result_file,
                                      args.result_upload_file)
    elif args.cmd == "seed":
        convert_seed_for_submission(args.annotation_file, args.result_file,
                                    args.result_upload_file)
    elif args.cmd == "mmbench":
        convert_mmbench_for_submission(args.annotation_file, args.result_dir,
                                       args.upload_dir, args.experiment)
    elif args.cmd == "mmvet":
        convert_mmvet_for_eval(args.src, args.dst)


if __name__ == "__main__":
    main()
