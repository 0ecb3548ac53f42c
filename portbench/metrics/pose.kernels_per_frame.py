"""Device kernels launched per frame served in the traced window (copies
and memsets left out)."""


def read(run):
    t, frames = run.trace, run.counters.get("frames", 0)
    if t is None or not frames:
        return None
    n = t.count(kind="kernel")
    return n / frames if n else None
