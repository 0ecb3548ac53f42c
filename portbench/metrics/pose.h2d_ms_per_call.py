"""Host time a call spent staging the frames, centres and scales on the
card (the ``e2e.h2d`` spans: the copies, the padding, u8 -> f32), in ms,
over the calls."""
from portbench import spans


def read(run):
    t, calls = run.trace, run.counters.get("calls", 0)
    if t is None or not calls:
        return None
    s = spans.total_s(t, "e2e.h2d")
    return None if s is None else s * 1e3 / calls
