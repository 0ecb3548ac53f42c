"""Host time of ViTPose's ``vit.blocks`` span (all transformer blocks of a
forward, dispatched from Python), summed over the traced window, in ms,
over the chunks. Beside ``pose.device_ms_per_frame`` it says whether the
host's dispatch or the device sets the pace."""
from portbench import spans


def read(run):
    t, chunks = run.trace, run.counters.get("chunks", 0)
    if t is None or not chunks:
        return None
    s = spans.total_s(t, "vit.blocks")
    return None if s is None else s * 1e3 / chunks
