"""CLI (reference: lmms-eval/lmms_eval/__main__.py:1-355; the PyTorch
port of ``matryoshka_mm_tpu/lmms_eval/__main__.py``).

    python -m matryoshka_mm_torch.lmms_eval --list_tasks
    python -m matryoshka_mm_torch.lmms_eval --model llava \
        --model_args pretrained=debug://tiny,device=cpu --tasks pope

``--device`` (or ``device=`` in ``--model_args``) picks the model's
device; the adapters load onto ``cuda`` by default.
"""

from __future__ import annotations

import argparse
import json
import os


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="llava")
    parser.add_argument("--model_args", type=str, default="")
    parser.add_argument("--tasks", type=str, default=None,
                        help="comma-separated task names")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--output_path", type=str, default=None)
    parser.add_argument("--log_samples", action="store_true")
    parser.add_argument("--matryoshka_vis_token_scale", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="appended to --model_args as device=...")
    parser.add_argument("--list_tasks", action="store_true")
    parser.add_argument("--check_integrity", action="store_true")
    parser.add_argument("--wandb_args", type=str, default=None,
                        help="log results/samples tables, e.g. "
                             "'project=lmms-eval,name=run1' (reference: "
                             "logging_utils.py WandbLogger)")
    args = parser.parse_args()

    from .api.registry import list_tasks
    from .evaluator import make_table, simple_evaluate

    if args.list_tasks:
        print("\n".join(list_tasks()))
        return
    if args.check_integrity:
        from .evaluator import check_integrity

        problems = check_integrity(args.tasks.split(",") if args.tasks
                                   else None)
        print("\n".join(problems) if problems else
              "all task configs are consistent")
        raise SystemExit(1 if problems else 0)
    if not args.tasks:
        parser.error("--tasks is required (or use --list_tasks)")

    model_args = args.model_args
    if args.device:
        model_args = ",".join(p for p in (model_args, f"device={args.device}")
                              if p)
    results = simple_evaluate(
        model=args.model,
        model_args=model_args,
        tasks=args.tasks.split(","),
        limit=args.limit,
        seed=args.seed,
        matryoshka_vis_token_scale=args.matryoshka_vis_token_scale,
        log_samples=args.log_samples,
    )
    print(make_table(results))
    if args.output_path:
        os.makedirs(os.path.dirname(args.output_path) or ".", exist_ok=True)
        with open(args.output_path, "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(f"wrote {args.output_path}")
    if args.wandb_args is not None:
        from .logging_utils import EvalLogger

        kw = dict(p.split("=", 1) for p in args.wandb_args.split(",") if p)
        logger = EvalLogger(
            project=kw.get("project", "lmms-eval"),
            name=kw.get("name"),
            config=vars(args),
            output_dir=kw.get("dir", os.path.dirname(args.output_path or "")
                              or "./logs"))
        logger.post_init(results)
        logger.log_eval_result()
        if args.log_samples:
            logger.log_eval_samples(results.get("samples", {}))
        logger.finish()


if __name__ == "__main__":
    main()
