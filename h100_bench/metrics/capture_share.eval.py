"""``generate.py`` ``DecodeGraph`` over ``utils/cuda_graph.py``
``CapturedStep``: the seconds the window's calls spent warming up and
capturing their decode graphs (the program's ``CapturedStep.warmup_s`` and
``capture_s`` counters) over the window's seconds, in percent."""


def read(run):
    w = run["window"]
    return 100.0 * w["capture_s"] / w["elapsed"] if w["elapsed"] else None
