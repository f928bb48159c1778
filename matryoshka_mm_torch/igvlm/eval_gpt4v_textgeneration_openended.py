"""IG-VLM text-generation benchmark via an API vision model
(reference: IG-VLM/eval_gpt4v_textgeneration_openended.py): the five
judged dimensions (CI/DO/CU/TU/CO) of the llava entry, with the
Gpt4vPipeline backend.
The PyTorch port of ``matryoshka_mm_tpu/igvlm/eval_gpt4v_textgeneration_openended.py``.
"""

from __future__ import annotations

import os

from .eval_gpt4v_openended import OPEN_ENDED_PROMPT, build_parser
from .eval_llava_textgeneration_openended import _EVAL_TYPES
from .evaluation import eval_gpt3, eval_gpt3_consistency, summarize_judge
from .pipeline import Gpt4vPipeline


def _predict(args, path_qa, tag, post_fn=None):
    os.makedirs(args.path_result, exist_ok=True)
    pipeline = Gpt4vPipeline(
        path_qa, args.path_video,
        os.path.join(args.path_result, f"preds_{tag}.csv"),
        model_version=args.model_version,
        frame_fixed_number=args.frame_fixed_number, post_fn=post_fn)
    pipeline.set_component(OPEN_ENDED_PROMPT, max_new_tokens=256)
    df, path = pipeline.do_pipeline()
    print(f"gpt4v prediction result ({tag}): {path}")
    return df


def run(args, judge=None, post_fn=None):
    if args.api_key:
        # an explicit --api_key must beat a stale exported env var
        os.environ["OPENAI_API_KEY"] = args.api_key
    if args.eval_type == "consistency":
        if not args.path_qa_pair_csv2:
            raise SystemExit("consistency (CO) needs --path_qa_pair_csv2 "
                             "with the paired questions")
        df1 = _predict(args, args.path_qa_pair_csv, "q1", post_fn)
        df2 = _predict(args, args.path_qa_pair_csv2, "q2", post_fn)
        gpt3_dir = os.path.join(args.path_result, "results_gpt3_consistency")
        df_qa, path_merged = eval_gpt3_consistency(
            df1, df2, gpt3_dir, judge=judge, api_key=args.api_key)
    else:
        df = _predict(args, args.path_qa_pair_csv, args.eval_type, post_fn)
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
