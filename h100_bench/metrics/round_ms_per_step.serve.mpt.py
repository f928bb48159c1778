"""Decode round layer (``serve/paged_cache.py`` ``CapturedRound``) of an
MPT cell, whose rounds attend through the paged pool's gather path: the
reading of ``round_ms_per_step.serve``, moving MPT's own
``tpot_p95_ms.mpt``."""

from h100_bench import readings


def read(run):
    return readings.round_ms_per_step(run)
