"""Device in an MPT serving cell: the reading of ``idle_share.serve``,
moving MPT's own ``tpot_p95_ms.mpt``."""

from h100_bench import readings


def read(run):
    return readings.idle_share(run)
