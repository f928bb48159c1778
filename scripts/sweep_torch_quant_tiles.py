#!/usr/bin/env python3
"""Time the port's quantized prefill kernel (``csrc/quant_matmul.cu``
``quant_wgmma_kernel``, ``int4_matmul`` / ``int8_matmul`` at M > 8 rows)
at every configuration it builds, on one NVIDIA GPU:

    python3 scripts/sweep_torch_quant_tiles.py [int4] [int8]

For the 7B projections at the prefill rows of
``chip_smoke.QUANT_PREFILL_ROWS`` (192, 640, 1024): the kernel's time
(``chip_smoke.time_ms``: back-to-back calls, operands rotated past the L2
cache) at each (rows a block, ring stages) of ``TILES``, the blocks of its
grid, the configuration the launcher picks (``mma_tile``) with its TFLOP/s
and share of the operations bound (2 M N K over 989 TFLOP/s), the fastest
configuration, and bf16 ``F.linear`` on the dequantized weight as a
yardstick.  Prints one line a case and the card's name and power limit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from matryoshka_mm_torch.ops import int4_matmul as mm  # noqa: E402
from matryoshka_mm_torch.ops import quant  # noqa: E402

# the configurations csrc/quant_matmul.cu builds: (rows, channels, ring
# stages) of a block
TILES = ((64, 128, 4), (128, 256, 4))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    gen = torch.Generator(device=dev).manual_seed(0)
    linear = torch.nn.functional.linear
    for bits in [int(a[3:]) for a in argv] or [4, 8]:
        quantize = quant.quantize_array_int4 if bits == 4 \
            else quant.quantize_array
        key = quant.Q4KEY if bits == 4 else quant.QKEY
        for shape, (N, K) in cs.QUANT_SHAPES.items():
            leaf = quantize(cs._rand((N, K), gen, dev).mul_(0.02))
            w, sc = leaf[key], leaf["scale"]
            wdq = quant.dequantize_array(leaf)
            del leaf
            for M in cs.QUANT_PREFILL_ROWS:
                x = cs._rand((M, K), gen, dev)
                ops = cs.rotations(x, w, sc)
                times = {t: cs.time_ms(
                    lambda x, w, sc, t=t: mm._launch("sweep", bits, x, w, sc,
                                                     tile=t), ops)
                    for t in TILES}
                lin = cs.time_ms(linear, cs.rotations(x, wdq))
                pick = mm.mma_tile(bits, M, N)[0]
                best = min(times, key=times.get)
                t_ops = 2 * M * N * K / cs.PEAK_FLOPS * 1e3
                name = "{}x{}x{}".format
                print(f"[sweep int{bits} {shape} M={M}] "
                      + "  ".join(
                          f"{name(*t)} ({-(-M // t[0]) * -(-N // t[1])} "
                          f"blocks) {ms:.4f}" for t, ms in times.items())
                      + f"  | pick {name(*pick)} {times[pick]:.4f} ms "
                      f"{2 * M * N * K / times[pick] / 1e9:.1f} TFLOP/s "
                      f"({100 * t_ops / times[pick]:.0f}% of the operations "
                      f"bound {t_ops:.4f}), best {name(*best)} "
                      f"({100 * t_ops / times[best]:.0f}%)  bf16_linear_ms "
                      f"{lin:.4f}")
                del ops
            del w, sc, wdq
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
