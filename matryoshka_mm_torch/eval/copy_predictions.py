"""Collect benchmark submission artifacts into an upload directory.

Counterpart of the reference's upload helper (reference:
llava/eval/copy_predictions.py:1-30, which only handles the MMBench
xlsx).  This version sweeps every known submission format produced by
eval/converters.py out of a checkpoint's eval tree:

* mmbench:  ``eval/mmbench*/**/*.xlsx`` (or the tsv fallback the
  converter writes when openpyxl is unavailable)
* vqav2:    ``eval/vqav2/**/ *.json`` submission files
* vizwiz:   ``eval/vizwiz/**/ *.json``

Files land in ``<upload_dir>/<task>/<experiment>.<ext>`` where the
experiment name is derived from the path under the checkpoint dir, so
submissions from several checkpoints can share one upload tree.

Usage: python -m matryoshka_mm_torch.eval.copy_predictions <ckpt_dir> <upload_dir>
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil

_TASK_PATTERNS = {
    "mmbench": ("eval/mmbench*/**/*.xlsx", "eval/mmbench*/**/*.tsv"),
    "vqav2": ("eval/vqav2/**/*.json",),
    "vizwiz": ("eval/vizwiz/**/*.json",),
}


def collect(ckpt_dir: str, upload_dir: str) -> list:
    """Copy all submission artifacts; returns [(src, dst), ...]."""
    copied = []
    for task, patterns in _TASK_PATTERNS.items():
        for pat in patterns:
            for src in sorted(glob.glob(os.path.join(ckpt_dir, pat),
                                        recursive=True)):
                rel = os.path.relpath(src, ckpt_dir)
                # experiment name: the path with separators flattened,
                # minus the leading eval/<task> segments.  Only the exact
                # task directory is dropped — prefix-matching would
                # collapse mmbench_cn / mmbench_dev_* split dirs into the
                # same name and silently overwrite submissions.
                parts = [p for p in rel.split(os.sep)
                         if p not in ("eval", task)]
                name = "_".join(parts) if parts else os.path.basename(src)
                task_dir = os.path.join(upload_dir, task)
                os.makedirs(task_dir, exist_ok=True)
                dst = os.path.join(task_dir, name)
                shutil.copy(src, dst)
                copied.append((src, dst))
    return copied


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt_dir")
    ap.add_argument("upload_dir")
    args = ap.parse_args()
    copied = collect(args.ckpt_dir, args.upload_dir)
    if not copied:
        raise SystemExit(f"no submission artifacts found under "
                         f"{args.ckpt_dir} (looked for "
                         f"{sorted(_TASK_PATTERNS)})")
    for src, dst in copied:
        print(f"{src}\n\t-> {dst}")


if __name__ == "__main__":
    main()
