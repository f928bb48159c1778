"""IG-VLM multiple-choice video QA entry
(reference: IG-VLM/eval_llava_multiplechoice.py; the PyTorch port of
``matryoshka_mm_tpu/igvlm/eval_llava_multiplechoice.py``, with its
``main`` split into ``build_parser`` and ``run``).

    python -m matryoshka_mm_torch.igvlm.eval_llava_multiplechoice \
        --path_qa_pair_csv qa.csv --path_video videos \
        --path_result preds.csv --model-path debug://7b [--device cpu]
"""

from __future__ import annotations

import argparse

from .evaluation import eval_multiple_choice
from .pipeline import LlavaPipeline


MC_PROMPT = ("Question: {question}\nOptions:\n{options}\nAnswer with the "
             "option's letter from the given choices directly.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path_qa_pair_csv", type=str, required=True)
    parser.add_argument("--path_video", type=str, required=True)
    parser.add_argument("--path_result", type=str, required=True)
    parser.add_argument("--model-path", type=str, default="debug://tiny")
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--matryoshka_vis_token_scale", type=str, default=None)
    parser.add_argument("--frame_fixed_number", type=int, default=6)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def run(args):
    pipeline = LlavaPipeline(
        args.model_path, args.path_qa_pair_csv, args.path_video,
        args.path_result, model_base=args.model_base,
        matryoshka_vis_token_scale=args.matryoshka_vis_token_scale,
        frame_fixed_number=args.frame_fixed_number, device=args.device)
    pipeline.set_component(MC_PROMPT, max_new_tokens=8)
    df, path = pipeline.do_pipeline()
    print(f"results written to {path}")
    return df, eval_multiple_choice(df)


def main():
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
