"""Host time of one K3 wrapper call (the mean ``k3.forward`` span:
argument checks, the slot array, the C entry and its launches), in us."""
from portbench import spans


def read(run):
    t = run.trace
    if t is None:
        return None
    s = spans.mean_s(t, "k3.forward")
    return None if s is None else s * 1e6
