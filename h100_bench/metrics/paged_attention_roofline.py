"""Kernel #7 (``ops/paged_attention.py``, ``paged_kernel``): the least time
its launches in the traced window could take (``work.py``: every live K and
V slot, query and output byte once, at 3.35 TB/s) over their device time,
in percent.  The bytes a launch needs come from the rows' live lengths of
the rounds dispatched in the window (the benchmark records each round's
input state), averaged over their launches and multiplied by the launches
the profiler saw.  Nothing to read where the kernel never launches (MPT
and any window config take the gather path)."""

from h100_bench import readings, work


def read(run):
    if not readings.traced(run):
        return None
    secs, n = run["tracer"].time_by_name(lambda s: "paged_kernel" in s)
    if not n or secs <= 0:
        return None
    a, b = readings.trace_bounds(run)
    ops, nbytes, launches = readings.paged_round_work(
        run, readings.rounds_between(run, a, b))
    if not launches:
        return None
    bound = n * work.roofline_seconds(ops / launches, nbytes / launches)
    return 100.0 * bound / secs
