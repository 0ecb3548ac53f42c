"""The whole forward's share of the card's bf16 peak: End2End's
operations per frame (``work.end2end_flops``) times the traced window's
own frames per second, over 989 TFLOP/s."""
from portbench import work


def read(run):
    t, frames = run.trace, run.counters.get("frames", 0)
    if t is None or not frames or t.window_s <= 0:
        return None
    rate = work.end2end_flops(run.config) * frames / t.window_s
    return 100.0 * rate / work.PEAK_FLOPS["bf16"]
