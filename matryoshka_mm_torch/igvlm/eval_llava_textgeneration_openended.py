"""IG-VLM text-generation benchmark entry
(reference: IG-VLM/eval_llava_textgeneration_openended.py).

The benchmark has five judged dimensions: CI (correctness), DO (detail
orientation), CU (context understanding), TU (temporal understanding) and
CO (consistency).  ``--eval_type`` selects CI/DO/CU/TU; CO needs two runs
over the paired question csvs and ``--path_qa_pair_csv2``.  The PyTorch
port of ``matryoshka_mm_tpu/igvlm/eval_llava_textgeneration_openended.py``
(``--device``, from the open-ended entry's parser, picks the model's
device).
"""

from __future__ import annotations

import argparse
import os

from .evaluation import (EvaluationType, eval_gpt3, eval_gpt3_consistency,
                         summarize_judge)
from .eval_llava_openended import OPEN_ENDED_PROMPT, build_parser
from .pipeline import LlavaPipeline

_EVAL_TYPES = {
    "correctness": EvaluationType.CORRECTNESS,
    "detailed": EvaluationType.DETAILED_ORIENTATION,
    "context": EvaluationType.CONTEXT,
    "temporal": EvaluationType.TEMPORAL,
    "consistency": None,  # paired path below
}


def _predict(args, path_qa, tag, judge=None):
    os.makedirs(args.path_result, exist_ok=True)
    pipeline = LlavaPipeline(
        args.model_path, path_qa, args.path_video,
        os.path.join(args.path_result, f"preds_{tag}.csv"),
        model_base=args.model_base,
        matryoshka_vis_token_scale=args.matryoshka_vis_token_scale,
        frame_fixed_number=args.frame_fixed_number, device=args.device)
    pipeline.set_component(OPEN_ENDED_PROMPT, max_new_tokens=256)
    df, path = pipeline.do_pipeline()
    print(f"llava prediction result ({tag}): {path}")
    return df


def run(args, judge=None):
    if args.eval_type == "consistency":
        if not args.path_qa_pair_csv2:
            raise SystemExit("consistency (CO) needs --path_qa_pair_csv2 "
                             "with the paired questions")
        df1 = _predict(args, args.path_qa_pair_csv, "q1", judge)
        df2 = _predict(args, args.path_qa_pair_csv2, "q2", judge)
        gpt3_dir = os.path.join(args.path_result, "results_gpt3_consistency")
        df_qa, path_merged = eval_gpt3_consistency(
            df1, df2, gpt3_dir, judge=judge, api_key=args.api_key)
    else:
        df = _predict(args, args.path_qa_pair_csv, args.eval_type, judge)
        gpt3_dir = os.path.join(args.path_result,
                                f"results_gpt3_{args.eval_type}")
        df_qa, path_merged = eval_gpt3(
            df, gpt3_dir, judge=judge,
            gpt_eval_type=_EVAL_TYPES[args.eval_type], api_key=args.api_key)
    print(f"GPT-judge result file: {path_merged}")
    summary = summarize_judge(df_qa)
    print(f"Score : {summary['score']}")
    return df_qa, summary


def main():
    parser = build_parser()
    parser.add_argument("--eval_type", type=str, default="correctness",
                        choices=sorted(_EVAL_TYPES))
    parser.add_argument("--path_qa_pair_csv2", type=str, default=None,
                        help="paired questions csv for consistency (CO)")
    run(parser.parse_args())


if __name__ == "__main__":
    main()
