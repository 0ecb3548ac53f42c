"""The caller's time between calls: the traced window's time outside every
``e2e.predict`` span, in ms, over the calls made in it."""
from portbench import spans


def read(run):
    t, calls = run.trace, run.counters.get("calls", 0)
    if t is None or not calls:
        return None
    s = spans.outside_s(t, "e2e.predict")
    return None if s is None else s * 1e3 / calls
