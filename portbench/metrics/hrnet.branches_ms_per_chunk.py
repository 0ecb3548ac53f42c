"""Host time of HRNet's ``hrnet.branches`` spans (each multi-branch module's
BasicBlock chains on every branch: their convs, BNs, sums and ReLUs
dispatched from Python), summed over the traced window, in ms, over the
chunks."""
from portbench import spans


def read(run):
    t, chunks = run.trace, run.counters.get("chunks", 0)
    if t is None or not chunks:
        return None
    s = spans.total_s(t, "hrnet.branches")
    return None if s is None else s * 1e3 / chunks
