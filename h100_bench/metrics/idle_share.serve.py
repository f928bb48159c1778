"""Device: the share of the traced seconds in which no operation ran on
the card (one minus the union of the profiler's device intervals over the
traced seconds), in percent."""

from h100_bench import readings


def read(run):
    return readings.idle_share(run)
