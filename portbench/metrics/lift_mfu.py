"""The lifter's share of the card's bf16 peak: 2 x its multiply-adds per
pose times the traced window's own poses per second, over 989 TFLOP/s."""
from portbench import work


def read(run):
    t, poses = run.trace, run.counters.get("poses", 0)
    if t is None or not poses or t.window_s <= 0:
        return None
    rate = 2 * work.lifter_macs(run.config) * poses / t.window_s
    return 100.0 * rate / work.PEAK_FLOPS["bf16"]
