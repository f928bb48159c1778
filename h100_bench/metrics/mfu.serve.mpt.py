"""Whole step of an MPT serving cell: the reading of ``mfu.serve``, moving
MPT's own ``tpot_p95_ms.mpt``."""

from h100_bench import readings


def read(run):
    return readings.serve_mfu(run)
