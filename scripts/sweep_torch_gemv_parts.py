#!/usr/bin/env python3
"""Time the port's decode-narrow quantized kernel (``csrc/quant_gemv.cuh``)
at every split of K over the warps of a block, on one NVIDIA GPU:

    python3 scripts/sweep_torch_gemv_parts.py [int4] [int8]

For the 7B projections (qkv, o, down, lm_head as ``int4_matmul`` /
``int8_matmul``; gate/up as the first launch of ``quant_mlp``, timed as
the whole call with the down launch at its rule's split) at M in {1, 4, 8}:
the kernel's time (``chip_smoke.time_ms``: back-to-back calls, operands
rotated past the L2 cache) at parts in {1, 2, 4, 8}, the split that
``gemv_parts`` picks, and the share of the byte bound (weights, scales and
activations read once, the output written once, over 3.35 TB/s) of the
rule's time.  Prints one line a case and the card's name and power limit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from matryoshka_mm_torch.ops import fused_mlp as mlp  # noqa: E402
from matryoshka_mm_torch.ops import int4_matmul as mm  # noqa: E402
from matryoshka_mm_torch.ops import quant  # noqa: E402
from matryoshka_mm_torch.ops.decode_attention import _sm_count  # noqa: E402

PARTS = (1, 2, 4, 8)
ROWS = (1, 4, 8)


def _line(label, times, rule, moved):
    best = min(times, key=times.get)
    share = moved / cs.HBM_BYTES_S * 1e3 / times[rule]
    print(f"[sweep {label}] "
          + "  ".join(f"p={p} {t:.4f}" for p, t in times.items())
          + f"  | rule p={rule} {times[rule]:.4f} ms ({100 * share:.0f}% of "
          f"the byte bound), best p={best}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    sms = _sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for bits in [int(a[3:]) for a in argv] or [4, 8]:
        quantize = quant.quantize_array_int4 if bits == 4 \
            else quant.quantize_array
        key = quant.Q4KEY if bits == 4 else quant.QKEY
        for shape, (N, K) in cs.QUANT_SHAPES.items():
            if shape == "gateup":
                continue
            leaf = quantize(cs._rand((N, K), gen, dev).mul_(0.02))
            w, sc = leaf[key], leaf["scale"]
            for M in ROWS:
                x = cs._rand((M, K), gen, dev)
                ops = cs.rotations(x, w, sc)
                times = {p: cs.time_ms(
                    lambda x, w, sc, p=p: mm._launch("sweep", bits, x, w, sc,
                                                     parts=p), ops)
                    for p in PARTS}
                _line(f"int{bits} {shape} M={M}", times,
                      mm.gemv_parts(N, K, bits, sms),
                      cs.nbytes(x, w, sc) + M * N * 2)
                del ops
            del leaf, w, sc
        D, I = 4096, 11008
        gate = quantize(cs._rand((I, D), gen, dev).mul_(0.02))
        up = quantize(cs._rand((I, D), gen, dev).mul_(0.02))
        gu = {key: torch.cat([gate[key], up[key]]),
              "scale": torch.cat([gate["scale"], up["scale"]])}
        del gate, up
        down = quantize(cs._rand((D, I), gen, dev).mul_(0.02))
        for M in ROWS:
            x = cs._rand((M, D), gen, dev)
            ops = cs.rotations(x, gu[key], gu["scale"], down[key],
                               down["scale"])
            times = {}
            for p in PARTS:
                def call(x, gq, gs, dq, ds, p=p):
                    return mlp._launch(x, {key: gq, "scale": gs},
                                       {key: dq, "scale": ds}, bits, I,
                                       parts_gu=p)
                times[p] = cs.time_ms(call, ops)
            _line(f"int{bits} quant_mlp (gate/up split) M={M}", times,
                  mm.gemv_parts(I, D, bits, sms, glu=True),
                  cs.nbytes(*ops[0]) + M * D * 2)
            del ops
        del gu, down
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
