"""Kernel #1 (``ops/flash_attention.py`` forward, ``flash_fwd`` launches)
in the traced ``generate`` calls: the least time their prefills could
take (``work.flash_fwd_work`` over every row's real spliced tokens, every
layer) over the device time of its launches, in percent."""

from h100_bench import work


def read(run):
    tr, w = run.get("tracer"), run["window"]
    if tr is None or tr.t1_ns is None:
        return None
    secs, n = tr.time_by_name(lambda s: "flash_fwd" in s)
    if not n:
        return None
    d = run["ctx"].spec.decoder
    lengths = [r.ids.shape[1] - 1 + r.req.scale
               for rows, t in zip(w["answered"], w["traced"]) if t
               for r in rows]
    ops, nbytes = work.flash_fwd_work(lengths, d.heads, d.kv_heads,
                                      d.head_dim, d.layers)
    return 100.0 * work.roofline_seconds(ops, nbytes) / secs
