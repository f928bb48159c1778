"""Create a license-safe weight delta: delta = target - base
(reference: llava/model/make_delta.py:1-52); the port of
``matryoshka_mm_tpu/models/make_delta.py``.

Operates on the port's checkpoints (``utils/checkpoint.py``).  Leaves
present only in the target (projector, router, vision tower) are stored
verbatim; embedding matrices may differ in vocab rows (added special
tokens): the overlapping rows are differenced, extra rows stored as-is.
The decoder's deltas are float32, as the JAX package writes them.

    python -m matryoshka_mm_torch.models.make_delta make \\
        --base-model-path B --target-model-path T --delta-path D
"""

from __future__ import annotations

import argparse

import torch

from ..utils.checkpoint import load_checkpoint, save_checkpoint


def _tree_map(fn, a, b):
    """``fn`` over the tensors of two trees of one structure."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise ValueError(f"trees differ: keys {sorted(a)} vs {sorted(b)}")
        return {k: _tree_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise ValueError(f"trees differ: {len(a)} vs {len(b)} entries")
        return [_tree_map(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def _delta_leaf(base: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    base, target = base.float(), target.float()
    if base.shape == target.shape:
        return target - base
    if not base.ndim == target.ndim == 2:
        raise ValueError(f"cannot difference {tuple(base.shape)} and "
                         f"{tuple(target.shape)}")
    out = target.clone()
    n = min(base.shape[0], target.shape[0])
    out[:n] = target[:n] - base[:n]
    return out


def _add_leaf(base: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    base, delta = base.float(), delta.float()
    if base.shape == delta.shape:
        return base + delta
    out = delta.clone()
    n = min(base.shape[0], delta.shape[0])
    out[:n] = base[:n] + delta[:n]
    return out


def make_delta(base_path: str, target_path: str, delta_path: str,
               device: str = "cuda") -> None:
    print(f"Loading base model from {base_path}")
    base, _ = load_checkpoint(base_path, device=device)
    print(f"Loading target model from {target_path}")
    target, cfg = load_checkpoint(target_path, device=device)

    out = dict(target)
    out["llama"] = _tree_map(_delta_leaf, base["llama"], target["llama"])
    save_checkpoint(delta_path, out, cfg, extra={"is_delta": True})
    print(f"Wrote delta to {delta_path}")


def apply_delta(base_path: str, target_path: str, delta_path: str,
                device: str = "cuda") -> None:
    """delta + base -> target (reference: llava/model/apply_delta.py:1-48)."""
    print(f"Loading base model from {base_path}")
    base, _ = load_checkpoint(base_path, device=device)
    print(f"Loading delta from {delta_path}")
    delta, cfg = load_checkpoint(delta_path, device=device)

    out = dict(delta)
    out["llama"] = _tree_map(_add_leaf, base["llama"], delta["llama"])
    save_checkpoint(target_path, out, cfg)
    print(f"Wrote target to {target_path}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["make", "apply"])
    parser.add_argument("--base-model-path", type=str, required=True)
    parser.add_argument("--target-model-path", type=str, required=True)
    parser.add_argument("--delta-path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    fn = make_delta if args.mode == "make" else apply_delta
    fn(args.base_model_path, args.target_model_path, args.delta_path,
       device=args.device)


if __name__ == "__main__":
    main()
