"""The whole forward's share of the card's bf16 peak with a ViTPose
detector: End2End's operations per frame (2 x ``work_vitpose.vitpose_macs``)
times the traced window's own frames per second, over 989 TFLOP/s, as
``pose_mfu`` reads the hourglass."""
from portbench import work, work_vitpose


def read(run):
    t, frames = run.trace, run.counters.get("frames", 0)
    if t is None or not frames or t.window_s <= 0:
        return None
    rate = 2 * work_vitpose.vitpose_macs(run.config) * frames / t.window_s
    return 100.0 * rate / work.PEAK_FLOPS["bf16"]
