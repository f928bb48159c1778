"""Prefill and admission layer (``generate.py`` ``prefill_image`` under
``_admit_group`` / ``_admit``): host milliseconds of one admission (CLIP,
pooling, the splice, the decoder's prefill, the page import), median over
the admissions that took a request of the window.  Read from the batcher's
event log."""

from h100_bench import readings, traffic


def read(run):
    want = readings.window_rids(run)
    ms = [d["ms"] for _, kind, d in run["window"]["events"] or ()
          if (kind == "admit_solo" and d["rid"] in want)
          or (kind == "admit_group" and want.intersection(d["rids"]))]
    return traffic.percentile(ms, 50) if ms else None
