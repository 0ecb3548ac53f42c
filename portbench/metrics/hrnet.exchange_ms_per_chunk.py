"""Host time of HRNet's ``hrnet.exchange`` spans (each multi-branch module's
exchange unit: its 1x1 and strided convs, BNs, upsamples, sums and ReLUs
dispatched from Python), summed over the traced window, in ms, over the
chunks."""
from portbench import spans


def read(run):
    t, chunks = run.trace, run.counters.get("chunks", 0)
    if t is None or not chunks:
        return None
    s = spans.total_s(t, "hrnet.exchange")
    return None if s is None else s * 1e3 / chunks
