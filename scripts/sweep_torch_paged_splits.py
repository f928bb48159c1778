#!/usr/bin/env python3
"""Time the port's paged decode-attention kernel at every split of a row's
slots, on one NVIDIA GPU:

    python3 scripts/sweep_torch_paged_splits.py [copy]

For the 7B shapes (H = Hkv = 32, Dh = 128, page 64, 25 pages a row, 32
layers of pools so that no call finds its pages in the L2 cache), bf16 and
int8 pools, three batches:

* ``b8 700``: B = 8, rows of 663-731 tokens (``chip_smoke.py`` phase 6);
* ``b8 one live``: B = 8, row lengths [700, 0, ..., 0], the batcher with
  one request live (it always launches ``max_batch`` rows);
* ``b1 700``: B = 1, one row of 700 tokens;

the kernel's time (``chip_smoke.time_ms``: back-to-back calls, operands
rotated past the L2 cache) at n_split in {1, 2, 4, 8}, the split that
``paged_splits`` picks and the bound (bytes over 3.35 TB/s).  Every time
is the mean of two readings taken in turns (n = 1, 2, 4, 8, 8, 4, 2, 1).

``copy`` also times the copy probe ``hbm_copy`` over 256 MiB against
``dst.copy_(src)`` in turns and shows what the library's copy runs on the
device.  Prints one line a case and the card's name and power limit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from matryoshka_mm_torch.ops import hbm_probe as hbm  # noqa: E402
from matryoshka_mm_torch.ops import paged_attention as pa  # noqa: E402

SPLITS = (1, 2, 4, 8)
L, PAGE, P, DH, H = 32, 64, 25, 128, 32
CASES = (("b8 700", [700, 663, 712, 689, 731, 702, 695, 708]),
         ("b8 one live", [700, 0, 0, 0, 0, 0, 0, 0]),
         ("b1 700", [700]))


def in_turns(fns: dict, ops) -> dict:
    """Each ``fns[key]`` timed twice, in the order keys, reversed keys; the
    mean of the two readings."""
    keys = list(fns)
    times = {key: 0.0 for key in keys}
    for key in keys + keys[::-1]:
        times[key] += cs.time_ms(fns[key], ops) / 2
    return times


def paged_cases(dev, sms: int) -> None:
    gen = torch.Generator(device=dev).manual_seed(2)
    for int8 in (False, True):
        for name, row_len in CASES:
            B = len(row_len)
            n_pages = B * P + 1
            k, v, ks, vs = cs._paged_pools(gen, dev, L, n_pages, PAGE, H, DH,
                                           int8)
            q = cs._rand((B, H, DH), gen, dev)
            perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
            tables = perm[:B * P].reshape(B, P).to(torch.int32)
            lens = torch.tensor(row_len, device=dev, dtype=torch.int32)
            ops = [(q, k[l], v[l], tables, lens,
                    None if ks is None else ks[l],
                    None if vs is None else vs[l]) for l in range(L)]
            work = cs._paged_work(lens, H, H, DH, k.element_size(), int8, q)
            fns = {n: (lambda *a, n=n: pa._launch(*a, n_split=n))
                   for n in SPLITS}
            times = in_turns(fns, ops)
            rule = pa.paged_splits(B, H, P, PAGE, sms)
            best = min(times, key=times.get)
            label = f"{'int8' if int8 else 'bf16'} {name}"
            print(f"[sweep {label}] "
                  + "  ".join(f"n={n} {t:.4f}" for n, t in times.items())
                  + f"  | rule n={rule} {times[rule]:.4f} ms, best n={best}, "
                  f"bound {work['bound_ms']:.4f} ms ({cs.card_line()})")
            del k, v, ks, vs, ops


def copy_against_library(dev) -> None:
    x = hbm._probe_array(256, dev)
    dst = torch.empty_like(x)
    if not torch.equal(hbm.hbm_copy(x, 1), x):
        raise SystemExit("hbm_copy is not a byte copy")
    times = in_turns({"hbm_copy": lambda a: hbm.hbm_copy(a, 1),
                      "copy_": lambda a: dst.copy_(a)}, [(x,)])
    b = cs.bound(2 * x.numel(), 0)["bound_ms"]
    print(f"[copy 256 MiB] hbm_copy {times['hbm_copy']:.4f} ms  copy_ "
          f"{times['copy_']:.4f} ms  bound {b:.4f} ms ({cs.card_line()})")
    # what the library's copy runs on the device: a kernel on the SMs or a
    # copy engine's transfer
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dst.copy_(x)
        torch.cuda.synchronize()
    print("[copy_ on the device] " + "; ".join(
        e.key for e in prof.key_averages()))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    paged_cases(dev, sms)
    if "copy" in argv:
        copy_against_library(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
