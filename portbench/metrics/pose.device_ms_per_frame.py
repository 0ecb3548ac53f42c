"""Device time per frame: the union of every device operation's interval
in the traced window, over the frames served in it."""


def read(run):
    t, frames = run.trace, run.counters.get("frames", 0)
    if t is None or not frames or not t.device:
        return None
    return t.busy_s() * 1e3 / frames
