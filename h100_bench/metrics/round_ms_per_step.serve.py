"""Decode round layer (``serve/paged_cache.py`` ``CapturedRound``): host
milliseconds from a round's dispatch to its results read back, over the
round's ``chunk`` steps, summed over every round that ended in the window
and divided by their steps.  Read from the batcher's event log."""

from h100_bench import readings


def read(run):
    return readings.round_ms_per_step(run)
