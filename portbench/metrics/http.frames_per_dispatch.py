"""Frames per backend call of the daemon's pose batcher over the traced
window (``DynamicBatcher.rows_served`` over ``batches_dispatched``, the
counters ``/metrics`` serves)."""


def read(run):
    batches = run.counters.get("batches", 0)
    if not batches:
        return None
    return run.counters["rows_served"] / batches
