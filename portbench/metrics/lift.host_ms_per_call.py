"""Host time of one ``LiftingServer.lift`` call (the ``lift.call`` spans:
normalise, K1, un-normalise, launched; a launch that waits for room in
the card's queue waits inside it), in ms, over the calls."""
from portbench import spans


def read(run):
    t, calls = run.trace, run.counters.get("calls", 0)
    if t is None or not calls:
        return None
    s = spans.total_s(t, "lift.call")
    return None if s is None else s * 1e3 / calls
