"""Consolidate a sharded torch checkpoint into a single native checkpoint
(reference: llava/model/consolidate.py:1-29); the port of
``matryoshka_mm_tpu/models/consolidate.py``.

Reads a HF / LLaVA checkpoint directory (possibly many shards) through
``load_pretrained_model`` and writes one checkpoint of the port
(``utils/checkpoint.py``).

    python -m matryoshka_mm_torch.models.consolidate --src S --dst D
"""

from __future__ import annotations

import argparse


def consolidate_ckpt(src_path: str, dst_path: str,
                     device: str = "cuda") -> None:
    from ..utils.checkpoint import save_checkpoint
    from .builder import load_pretrained_model

    print(f"Loading model from {src_path}")
    _, model, _, _ = load_pretrained_model(src_path, None, None,
                                           device=device)
    save_checkpoint(dst_path, model.params, model.cfg)
    print(f"Wrote consolidated checkpoint to {dst_path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", type=str, required=True)
    parser.add_argument("--dst", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    consolidate_ckpt(args.src, args.dst, device=args.device)
