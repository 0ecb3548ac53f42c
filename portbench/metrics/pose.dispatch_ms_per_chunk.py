"""Host time the model took to dispatch a chunk (the ``e2e.forward``
spans: detector, decode and lifter launched from Python), in ms, over the
chunks."""
from portbench import spans


def read(run):
    t, chunks = run.trace, run.counters.get("chunks", 0)
    if t is None or not chunks:
        return None
    s = spans.total_s(t, "e2e.forward")
    return None if s is None else s * 1e3 / chunks
