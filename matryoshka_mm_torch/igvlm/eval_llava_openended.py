"""IG-VLM open-ended video QA entry
(reference: IG-VLM/eval_llava_openended.py): grid inference over the QA
csv, then the GPT judge (yes/no + 0-5 score) with per-question resume.
The PyTorch port of ``matryoshka_mm_tpu/igvlm/eval_llava_openended.py``;
``--device`` picks the model's device (``cuda`` by default).
"""

from __future__ import annotations

import argparse
import os

from .evaluation import EvaluationType, eval_gpt3, summarize_judge
from .pipeline import LlavaPipeline

OPEN_ENDED_PROMPT = (
    "The provided image arranges keyframes from a video in a grid view. "
    "Answer concisely with overall content and context of the video, "
    "highlighting any significant events, characters, or objects that "
    "appear throughout the frames. Question: {question}?")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path_qa_pair_csv", type=str, required=True)
    parser.add_argument("--path_video", type=str, required=True)
    parser.add_argument("--path_result", type=str, required=True)
    parser.add_argument("--model-path", type=str, default="debug://tiny")
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--api_key", type=str, default=None,
                        help="OpenAI-compatible key for the GPT judge "
                             "(or set OPENAI_API_KEY)")
    parser.add_argument("--matryoshka_vis_token_scale", type=str, default=None)
    parser.add_argument("--frame_fixed_number", type=int, default=6)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def run(args, eval_type: EvaluationType = EvaluationType.DEFAULT,
        judge=None):
    os.makedirs(args.path_result, exist_ok=True)
    pipeline = LlavaPipeline(
        args.model_path, args.path_qa_pair_csv, args.path_video,
        os.path.join(args.path_result, "preds.csv"),
        model_base=args.model_base,
        matryoshka_vis_token_scale=args.matryoshka_vis_token_scale,
        frame_fixed_number=args.frame_fixed_number, device=args.device)
    pipeline.set_component(OPEN_ENDED_PROMPT, max_new_tokens=128)
    df, path = pipeline.do_pipeline()
    print(f"llava prediction result: {path}")

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
