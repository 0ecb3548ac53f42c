"""The server's own host time a call: the self time of the ``e2e.predict``
spans (what no span inside them covers: the numpy work before the first
chunk and after the copy back), in ms, over the calls."""
from portbench import spans


def read(run):
    t, calls = run.trace, run.counters.get("calls", 0)
    if t is None or not calls:
        return None
    s = spans.self_s(t, "e2e.predict")
    return None if s is None else s * 1e3 / calls
