"""Find a serving cell's knee once: the highest offered rate the pool
sustains without a growing backlog.

    python3 -m h100_bench.sweep_rate --workload <cell> --rates 8,12,16 \
        --seconds 20 [--seed n]

One process sets the cell up once and runs a window at each rate, in the
order given; every window drains before the next starts.  For each rate
it prints one JSON line: the time to first token (median and 95th
percentile), the time per output token (95th percentile), the queue wait
(submit to admission) in the first and the last third of the window, the
completed output tokens a second and the mean rows a round.  A backlog
that grows shows as a last-third queue wait well above the first third's,
rising with the rate; the knee is the highest rate before that.  The cell's
``rate_per_s`` is set by hand to about four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def sweep_line(win: dict, rate: float) -> dict:
    from .entries.serve import timings
    from .traffic import percentile

    t = timings(win)
    subs = {d["rid"]: tt for tt, k, d in win["events"] if k == "submit"}
    adm = {}
    for tt, k, d in win["events"]:
        for rid in ([d["rid"]] if k == "admit_solo" else
                    d["rids"] if k == "admit_group" else []):
            adm[rid] = tt - d["ms"] / 1e3
    start = win["t0"] + win["lead"]
    third = win["seconds"] / 3
    waits = {0: [], 2: []}
    for r in win["counted"]:
        part = int((r.due - start) // third)
        if part in waits and r.rid in adm and r.rid in subs:
            waits[part].append((adm[r.rid] - subs[r.rid]) * 1e3)
    toks = sum(len(r.tokens) for r in win["counted"])
    span = max(r.last for r in win["counted"] if r.last) - start
    rounds = [d["rows"] for _, k, d in win["events"] if k == "decode_round"]
    return {"rate": rate, "attempted": t["attempted"], "failed": t["failed"],
            "ttft_p50_ms": percentile(t["ttft_ms"], 50),
            "ttft_p95_ms": percentile(t["ttft_ms"], 95),
            "tpot_p95_ms": percentile(t["tpot_ms"], 95),
            "queue_wait_first_third_ms": float(np.mean(waits[0] or [np.nan])),
            "queue_wait_last_third_ms": float(np.mean(waits[2] or [np.nan])),
            "completed_tok_s": toks / span,
            "rows_a_round": float(np.mean(rounds or [np.nan]))}


def main(argv=None) -> int:
    import torch

    from .entries.serve import ServeCell
    from .run import HERE, load_context, power_limit, set_cache_dirs

    p = argparse.ArgumentParser(prog="h100_bench.sweep_rate")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    root = HERE.parent
    set_cache_dirs(root)
    if not torch.cuda.is_available():
        print("sweep_rate: no CUDA device", file=sys.stderr)
        return 2
    print(f"sweep_rate: {a.workload} on {power_limit()}", flush=True)
    ctx = load_context(root, a.workload, torch.device("cuda", 0))
    cell = ServeCell(ctx)
    cell.setup(a.seed)
    try:
        for rate in (float(x) for x in a.rates.split(",")):
            win = cell.window(rate, a.seconds, log_events=True)
            print(json.dumps(sweep_line(win, rate)), flush=True)
    finally:
        cell.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
