"""Engine layer (``serve/batching.py`` ``ContinuousBatcher``): how long a
request waits in the batcher's queue, from its ``submit`` event to the
start of the admission that takes it, 95th percentile over the window's
requests, in ms.  Read from the batcher's event log."""

from h100_bench import readings, traffic


def read(run):
    subs, adm = readings.submits(run), readings.admissions(run)
    waits = [(adm[rid][0] - subs[rid]) * 1e3
             for rid in readings.window_rids(run)
             if rid in subs and rid in adm]
    return traffic.percentile(waits, 95) if waits else None
