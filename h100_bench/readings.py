"""What the per-layer readers of the serving cells share: the batcher's
event log turned into per-request admissions, the rounds of the traced
window and the model FLOPs done in it.

A serving run's ``window`` holds ``events`` (the batcher's ``(perf_counter
time, kind, detail)`` log: ``submit`` with ``rid``; ``admit_solo`` with
``rid`` and ``ms``; ``admit_group`` with ``rids`` and ``ms``;
``decode_round`` with ``ms`` and ``rows``, each logged when it ends), and
in a traced run ``rounds``, each round's input state ``(dispatch time,
lengths, budget, active)`` as the benchmark saw it dispatched.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import work


def window_rids(run) -> set:
    """The rids of the window's requests (the profiler, in a traced run,
    opens only once every one of them has been admitted)."""
    return {r.rid for r in run["window"]["counted"]}


def admissions(run) -> Dict[int, Tuple[float, float]]:
    """``rid -> (admission start, admission end)`` in perf_counter
    seconds."""
    out = {}
    for t, kind, d in run["window"]["events"] or ():
        if kind == "admit_solo":
            out[d["rid"]] = (t - d["ms"] / 1e3, t)
        elif kind == "admit_group":
            for rid in d["rids"]:
                out[rid] = (t - d["ms"] / 1e3, t)
    return out


def submits(run) -> Dict[int, float]:
    return {d["rid"]: t for t, kind, d in run["window"]["events"] or ()
            if kind == "submit"}


def spliced_length(rec) -> int:
    """Prompt ids less the sentinel, plus the request's visual tokens."""
    return rec.ids.shape[1] - 1 + rec.req.scale


def traced(run) -> bool:
    t = run.get("tracer")
    return t is not None and t.t1_ns is not None


def to_perf(run, t_ns: int) -> float:
    p0, n0 = run["window"]["clock"]
    return p0 + (t_ns - n0) / 1e9


def rounds_between(run, a: float, b: float) -> List[tuple]:
    """The rounds dispatched in ``[a, b)`` (perf_counter seconds), their
    state as numpy arrays."""
    out = []
    for t, lengths, budget, active in run["window"]["rounds"]:
        if a <= t < b:
            out.append((t, lengths.cpu().numpy(), budget.cpu().numpy(),
                        active.cpu().numpy()))
    return out


def trace_bounds(run) -> Tuple[float, float]:
    tr = run["tracer"]
    return to_perf(run, tr.t0_ns), to_perf(run, tr.t1_ns)


def decode_flops(run, rounds) -> float:
    d = run["ctx"].spec.decoder.shape()
    steps = run["window"]["chunk"]
    per_pair = 4.0 * d.layers * d.heads * d.head_dim
    per_token = work.decode_token_flops(d, 0)
    total = 0.0
    for _, lengths, budget, active in rounds:
        for s in range(steps):
            live = active & (s < budget)
            n = int(live.sum())
            total += n * per_token + per_pair * float(
                (lengths[live] + s + 1).sum())
    return total


def prefill_flops_between(run, a: float, b: float) -> float:
    """Model FLOPs of the admissions that ended in ``[a, b)``: each
    request's prefill over its own spliced tokens and its image through
    the frozen tower and the projector."""
    spec = run["ctx"].spec
    d, v = spec.decoder.shape(), spec.vision_shape()
    by_rid = {r.rid: r for r in run["window"]["recs"]}
    total = 0.0
    for rid, (_, end) in admissions(run).items():
        if a <= end < b and rid in by_rid:
            total += work.prefill_flops(d, spliced_length(by_rid[rid])) \
                + work.vision_flops(v, 1)
    return total


def paged_round_work(run, rounds) -> Tuple[float, float, int]:
    """``(operations, bytes, launches)`` of kernel #7 over ``rounds``."""
    d = run["ctx"].spec.decoder
    ops = nbytes = 0.0
    launches = 0
    for _, lengths, budget, active in rounds:
        o, b, n, _ = work.round_paged_work(
            lengths, budget, active, run["window"]["chunk"], d.layers,
            d.heads, d.kv_heads, d.head_dim)
        ops, nbytes, launches = ops + o, nbytes + b, launches + n
    return ops, nbytes, launches


def window_span(run) -> Tuple[float, float]:
    """The window's arrivals, in perf_counter seconds."""
    w = run["window"]
    start = w["t0"] + w["lead"]
    return start, start + w["seconds"]


def round_ms_per_step(run):
    """Host ms from a round's dispatch to its results read back, over the
    round's steps, for the rounds that ended in the window."""
    a, b = window_span(run)
    ms = [d["ms"] for t, kind, d in run["window"]["events"] or ()
          if kind == "decode_round" and a <= t < b]
    if not ms:
        return None
    return sum(ms) / (len(ms) * run["window"]["chunk"])


def idle_share(run):
    """The share of the traced seconds in which no operation ran on the
    card, in percent."""
    if not traced(run):
        return None
    tr = run["tracer"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def serve_mfu(run):
    """Model FLOPs done in the traced seconds over the card's bf16 peak in
    that time, in percent: the decode tokens of the rounds dispatched in
    them and the prefills whose admission ended in them."""
    if not traced(run):
        return None
    a, b = trace_bounds(run)
    flops = decode_flops(run, rounds_between(run, a, b)) \
        + prefill_flops_between(run, a, b)
    return 100.0 * flops / ((b - a) * work.PEAK_BF16_FLOPS)
