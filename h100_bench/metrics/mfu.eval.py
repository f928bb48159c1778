"""Whole ``generate`` call: the model FLOPs of the window's untraced calls
(each row's prefill over its own spliced tokens, its image through the
frozen tower and the projector, and its decode tokens over their live
context; ``work.py``) over their host seconds times the card's bf16 peak,
in percent."""

from h100_bench import work


def read(run):
    w = run["window"]
    spec = run["ctx"].spec
    d, v = spec.decoder.shape(), spec.vision_shape()
    flops = secs = 0.0
    for rows, t, traced in zip(w["answered"], w["calls"], w["traced"]):
        if traced:
            continue
        secs += t
        for r in rows:
            n = r.ids.shape[1] - 1 + r.req.scale
            flops += work.prefill_flops(d, n) + work.vision_flops(v, 1) + sum(
                work.decode_token_flops(d, n + j)
                for j in range(1, len(r.tokens)))
    return 100.0 * flops / (secs * work.PEAK_BF16_FLOPS) if secs else None
