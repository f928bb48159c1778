"""Device during the traced ``generate`` calls: the share of the traced
window in which no operation ran on the card, in percent."""


def read(run):
    tr = run.get("tracer")
    if tr is None or tr.t1_ns is None:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
