"""Share of the traced window the pose batcher's dispatcher spent in
backend calls (``DynamicBatcher.dispatch_seconds``)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not run.counters.get("batches"):
        return None
    return 100.0 * run.counters["dispatch_s"] / t.window_s
