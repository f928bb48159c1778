"""IG-VLM open-ended video QA via an API vision model
(reference: IG-VLM/eval_gpt4v_openended.py): grid inference through the
OpenAI-compatible endpoint, then the same GPT judge (yes/no + 0-5 score)
with per-question resume.
The PyTorch port of ``matryoshka_mm_tpu/igvlm/eval_gpt4v_openended.py``.
"""

from __future__ import annotations

import argparse
import os

from .eval_llava_openended import OPEN_ENDED_PROMPT
from .evaluation import EvaluationType, eval_gpt3, summarize_judge
from .pipeline import Gpt4vPipeline


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path_qa_pair_csv", type=str, required=True)
    parser.add_argument("--path_video", type=str, required=True)
    parser.add_argument("--path_result", type=str, required=True)
    parser.add_argument("--api_key", type=str, default=None,
                        help="OpenAI-compatible key (or set OPENAI_API_KEY)")
    parser.add_argument("--model_version", type=str,
                        default="gpt-4-vision-preview")
    parser.add_argument("--frame_fixed_number", type=int, default=6)
    return parser


def run(args, eval_type: EvaluationType = EvaluationType.DEFAULT,
        judge=None, post_fn=None):
    if args.api_key:
        # an explicit --api_key must beat a stale exported env var
        os.environ["OPENAI_API_KEY"] = args.api_key
    os.makedirs(args.path_result, exist_ok=True)
    pipeline = Gpt4vPipeline(
        args.path_qa_pair_csv, args.path_video,
        os.path.join(args.path_result, "preds.csv"),
        model_version=args.model_version,
        frame_fixed_number=args.frame_fixed_number, post_fn=post_fn)
    pipeline.set_component(OPEN_ENDED_PROMPT, max_new_tokens=128)
    df, path = pipeline.do_pipeline()
    print(f"gpt4v prediction result: {path}")

    gpt3_dir = os.path.join(args.path_result, "results_gpt3_evaluation")
    df_qa, path_merged = eval_gpt3(df, gpt3_dir, judge=judge,
                                   gpt_eval_type=eval_type,
                                   api_key=args.api_key)
    print(f"GPT-judge result file: {path_merged}")
    summary = summarize_judge(df_qa)
    if "accuracy" in summary:
        print(f"Acc : {summary['accuracy']}")
    print(f"Score : {summary['score']}")
    return df_qa, summary


def main():
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
