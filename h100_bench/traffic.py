"""Traffic generation from a mix's data file and ``--seed``.

One generator serves every serving mix (``open_loop``) and every eval
sweep (``eval_sweep``); a mix is a JSON file of parameters under
``traffic/``.  The work does not depend on the seed: every seed gets the
same multiset of sizes and arrival gaps, in another order, so runs with
different seeds measure the same work.  Within each block of ``block``
consecutive requests the sizes are the block's stratified quantiles of
each length distribution (the midpoints ``(i + 0.5) / block``), the scales
each appear equally often, and the gaps are the exponential distribution's
stratified quantiles scaled to a mean of ``1 / rate``, all permuted by the
seed.  Locally the arrivals are as bursty as a Poisson process; over a
block the offered load is exact.

The seed also draws every token id and image, so two runs of one seed see
the same inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Sequence

import numpy as np

IMAGE_TOKEN = -200   # LLaVA's image sentinel in a prompt's ids


@dataclasses.dataclass
class Request:
    index: int
    due_s: float              # offset from the schedule's start
    text_tokens: int
    new_tokens: int
    scale: int
    image: int                # index into the run's image pool


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A generator for one purpose of one seed (``salt`` names it)."""
    return np.random.default_rng([int(seed) % (2 ** 63), *salt])


def stratified(dist: dict, n: int) -> np.ndarray:
    """The ``n`` midpoint quantiles of a length distribution, as ints:
    ``{"dist": "loguniform", "low", "high"}`` or ``{"dist": "fixed",
    "value"}``."""
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "loguniform":
        lo, hi = math.log(dist["low"]), math.log(dist["high"])
        vals = np.exp(lo + u * (hi - lo))
        return np.clip(np.rint(vals), dist["low"], dist["high"]).astype(int)
    if dist["dist"] == "fixed":
        return np.full(n, int(dist["value"]))
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def exponential_gaps(n: int, mean: float) -> np.ndarray:
    """The ``n`` midpoint quantiles of an exponential distribution, scaled
    so that they sum to ``n * mean`` exactly."""
    u = (np.arange(n) + 0.5) / n
    g = -np.log1p(-u)
    return g * (n * mean / g.sum())


def open_loop_schedule(mix: dict, rate: float, duration_s: float,
                       seed: int) -> List[Request]:
    """Requests due in ``[0, duration_s)`` at ``rate`` a second."""
    block = int(mix["block"])
    scales = list(mix["scales"])
    if block % len(scales):
        raise ValueError("a block must hold every scale equally often")
    n_blocks = int(math.ceil(duration_s * rate / block)) + 1
    r = rng(seed, 1)
    text = stratified(mix["text_tokens"], block)
    new = stratified(mix["new_tokens"], block)
    gaps = exponential_gaps(block, 1.0 / rate)
    scale_set = np.repeat(np.asarray(scales), block // len(scales))
    out: List[Request] = []
    t = 0.0
    for _ in range(n_blocks):
        g, tx, nw, sc = (r.permutation(a) for a in (gaps, text, new,
                                                     scale_set))
        for i in range(block):
            if t >= duration_s:
                return out
            out.append(Request(len(out), t, int(tx[i]), int(nw[i]),
                               int(sc[i]), len(out) % int(mix["images"])))
            t += float(g[i])
    return out


def prompt_ids(seed: int, req_index: int, text_tokens: int, vocab: int,
               image_token: int, bos: int = 1) -> np.ndarray:
    """``(1, 2 + text_tokens)`` ids: BOS, the image sentinel, then the text
    (ids drawn in ``[3, vocab)``)."""
    text = rng(seed, 2, req_index).integers(3, vocab, size=text_tokens)
    return np.concatenate([[bos, image_token], text]).astype(np.int32)[None]


def image_pool(seed: int, n: int, size: int) -> np.ndarray:
    """``(n, 3, size, size)`` float32 images, normalized-pixel-like
    (standard normal clipped to +-3)."""
    x = rng(seed, 3).standard_normal((n, 3, size, size), dtype=np.float32)
    return np.clip(x, -3.0, 3.0)


@dataclasses.dataclass
class EvalBatch:
    index: int
    scale: int
    text_tokens: List[int]    # per row, before padding


def eval_batches(mix: dict, n_batches: int, seed: int) -> Iterator[EvalBatch]:
    """Back-to-back ``generate`` calls of ``rows`` questions each, every row
    of a call at one scale and the scales cycling in order; the question
    lengths are stratified over each cycle of ``len(scales)`` calls."""
    rows, scales = int(mix["rows"]), list(mix["scales"])
    lens = stratified(mix["text_tokens"], rows * len(scales))
    r = rng(seed, 4)
    cycle = lens
    for i in range(n_batches):
        k = i % len(scales)
        if k == 0:
            cycle = r.permutation(lens)
        yield EvalBatch(i, scales[k],
                        [int(x) for x in cycle[k * rows:(k + 1) * rows]])


def percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (numpy's default), NaN when empty:
    the arithmetic of ``scripts/serve_bench.py`` ``pct``."""
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p)) \
        if len(xs) else float("nan")
