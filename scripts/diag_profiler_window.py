#!/usr/bin/env python3
"""Why a short ``torch.profiler`` window sometimes shows no kernel.

    python3 scripts/diag_profiler_window.py [rounds]

The card test ``test_flash_forward_design_follows_the_dtype_alone`` profiles
one flash-forward launch under ``profile(activities=[CUDA])`` and, in some
whole-file runs, found no ``flash_fwd`` kernel in the profile.  This script
opens such windows in one process, as the tests do after other profiler
windows, with other work on the card between them: ``rounds`` rounds
(default 150) of two windows (bf16 and float32 operands) in each of four
ways:

* ``as-test``: the test's first window: the launch, a synchronize;
* ``synced``: a synchronize before the window opens, then the same;
* ``margin 2``, ``margin 50``: a synchronize before, and 2 or 50 ms of
  host sleep in the window on each side of the launch and its synchronize.

For each way it prints how many windows held the kernel, and per window
that lost it the window's last event.  Where the kernel was found, it
collects the kernel's start less the start of the runtime call that
launched it (``cudaLaunchKernel*``), both as the profiler reports them
(``FunctionEvent.time_range``, microseconds), and prints their least,
median and greatest: a GPU clock that the profiler maps onto the host's
with a shifting offset shows as outliers there, and can move a kernel out
of the window, which the profiler then drops.  Prints the card's name and
power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv) -> int:
    from torch.profiler import ProfilerActivity, profile

    from matryoshka_mm_torch.ops import flash_attention as tflash

    if not torch.cuda.is_available():
        print("diag_profiler_window: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rounds = int(argv[0]) if argv else 150
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((1, 4, 130, 128), generator=g, device=dev,
                               dtype=dtype) for _ in range(3))
        valid = torch.ones((1, 130), dtype=torch.bool, device=dev)
        valid[0, :7] = False
        cases[dtype] = (q, k, v, valid)
        tflash.flash_attention_lse(q, k, v, kv_valid=valid)      # build
    busy = torch.randn((2048, 2048), generator=g, device=dev)

    def window(way, q, k, v, valid):
        margin = {"margin 2": 0.002, "margin 50": 0.05}.get(way, 0.0)
        if way != "as-test":
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            tflash.flash_attention_lse(q, k, v, kv_valid=valid)
            torch.cuda.synchronize()
            time.sleep(margin)
        events = prof.events()
        mine = [e for e in events if "flash_fwd" in e.name]
        calls = [e for e in events if e.name.startswith("cudaLaunchKernel")]
        end = max((e.time_range.end for e in events), default=0.0)
        lag = (mine[0].time_range.start - calls[-1].time_range.start
               if mine and calls else None)
        return mine, end, lag

    ways = ("as-test", "synced", "margin 2", "margin 50")
    found, lags = {}, {}
    for i in range(rounds):
        for way in ways:
            for dtype, case in cases.items():
                mine, end, lag = window(way, *case)
                found.setdefault(way, []).append(bool(mine))
                if lag is not None:
                    lags.setdefault(way, []).append(lag)
                if not mine:
                    print(f"[round {i:3d} {way:9s} {str(dtype)[6:]:8s}] NO "
                          f"KERNEL; last event ends {end:.1f} us")
            # other work between the windows, as other tests do
            for _ in range(4):
                busy = busy @ busy
                busy = busy / busy.norm()
        time.sleep(0.05)
    for way in ways:
        hits, lag = found[way], sorted(lags.get(way, [0.0]))
        print(f"[summary] {way}: the kernel in {sum(hits)} of {len(hits)} "
              f"windows; kernel start less launch call start: least "
              f"{lag[0]:.1f} us, median {lag[len(lag) // 2]:.1f} us, "
              f"greatest {lag[-1]:.1f} us; beyond 0..200 us in "
              f"{sum(not 0 <= x <= 200 for x in lag)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
