"""Kernel #3 (``ops/flash_attention.py`` backward: ``flash_bwd_dq`` and
``flash_bwd_dkv`` launches) in the traced train step: the least time its
work could take (``work.flash_bwd_work`` over every (scale, sample) row's
real tokens, every layer, for each traced step) over the device time of
its launches, in percent."""

from h100_bench import work


def read(run):
    tr, w = run.get("tracer"), run["window"]
    if tr is None or tr.t1_ns is None or not w["n_traced"]:
        return None
    secs, n = tr.time_by_name(lambda s: "flash_bwd" in s)
    if not n:
        return None
    d = run["ctx"].spec.decoder
    ops, nbytes = work.flash_bwd_work(w["work"]["rows"], d.heads, d.kv_heads,
                                      d.head_dim, d.layers)
    return 100.0 * w["n_traced"] * work.roofline_seconds(ops, nbytes) / secs
