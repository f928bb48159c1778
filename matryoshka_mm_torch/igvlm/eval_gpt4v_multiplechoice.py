"""IG-VLM multiple-choice video QA via an API vision model
(reference: IG-VLM/eval_gpt4v_multiplechoice.py): identical video->grid
preprocessing and exact-match scoring as the llava entry, answered by an
OpenAI-compatible endpoint (Gpt4vPipeline).
The PyTorch port of ``matryoshka_mm_tpu/igvlm/eval_gpt4v_multiplechoice.py``.
"""

from __future__ import annotations

import argparse
import os

from .evaluation import eval_multiple_choice
from .pipeline import Gpt4vPipeline

MC_PROMPT = (
    "The provided image arranges keyframes from a video in a grid view, "
    "in chronological order from top left to bottom right. "
    "Question: {question}\nOptions:\n{options}\nAnswer with the option's "
    "letter from the given choices directly.")


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


def run(args, post_fn=None):
    if args.api_key:
        # an explicit --api_key must beat a stale exported env var
        os.environ["OPENAI_API_KEY"] = args.api_key
    pipeline = Gpt4vPipeline(
        args.path_qa_pair_csv, args.path_video, args.path_result,
        model_version=args.model_version,
        frame_fixed_number=args.frame_fixed_number, post_fn=post_fn)
    pipeline.set_component(MC_PROMPT, max_new_tokens=8)
    df, path = pipeline.do_pipeline()
    print(f"results written to {path}")
    return eval_multiple_choice(df)


def main():
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
