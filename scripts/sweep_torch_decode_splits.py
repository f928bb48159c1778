#!/usr/bin/env python3
"""Time the port's dense decode-attention kernel at every split of the
slots, on one NVIDIA GPU:

    python3 scripts/sweep_torch_decode_splits.py

For the 7B shapes (H = Hkv = 32, Dh = 128) at B in {1, 2, 4, 8} and S in
{672, 1024, 4096}, bf16 and int8 caches, every slot valid: the kernel's
time (``chip_smoke.time_ms``: back-to-back calls, operands rotated past the
L2 cache) at n_split in {1, 2, 3, 4, 6, 8}, the split that
``decode_splits`` picks, and the time of ``scaled_dot_product_attention``
on the bf16 operands.  Prints one line a case and the card's name and
power limit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from matryoshka_mm_torch.ops import decode_attention as dec  # noqa: E402
from matryoshka_mm_torch.ops.quant import _quantize_kv_slots  # noqa: E402

SPLITS = (1, 2, 3, 4, 6, 8)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    sms = dec._sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    H = Hkv = 32
    Dh = 128
    for int8 in (False, True):
        for B in (1, 2, 4, 8):
            for S in (672, 1024, 4096):
                q = cs._rand((B, H, Dh), gen, dev)
                k, v = cs._rand((B, S, Hkv, Dh), gen, dev), \
                    cs._rand((B, S, Hkv, Dh), gen, dev)
                valid = torch.ones((B, S), dtype=torch.bool, device=dev)
                kv_pos = torch.arange(S, device=dev,
                                      dtype=torch.int32).expand(B, S)
                q_pos = torch.full((B,), S - 1, device=dev, dtype=torch.int32)
                lib = cs.library_ms("decode", cs.rotations(
                    q, k, v, valid, kv_pos, q_pos))
                if int8:
                    (k, ks), (v, vs) = _quantize_kv_slots(k), \
                        _quantize_kv_slots(v)
                    ops = cs.rotations(q, k, v, valid, kv_pos, q_pos, ks, vs)
                else:
                    ops = cs.rotations(q, k, v, valid, kv_pos, q_pos)
                times = {}
                for n in SPLITS:
                    def call(*a, n=n):
                        kw = dict(k_scale=a[6], v_scale=a[7]) if int8 else {}
                        return dec._launch(*a[:6], 0, n_split=n, **kw)
                    times[n] = cs.time_ms(call, ops)
                rule = dec.decode_splits(B, Hkv, S, sms)
                best = min(times, key=times.get)
                print(f"[sweep {'int8' if int8 else 'bf16'} B={B} S={S}] "
                      + "  ".join(f"n={n} {t:.4f}" for n, t in times.items())
                      + f"  | rule n={rule} {times[rule]:.4f} ms, best n="
                      f"{best}; library (bf16 operands) {lib:.4f} ms")
                del ops, q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
