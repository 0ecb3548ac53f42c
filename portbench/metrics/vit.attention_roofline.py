"""ViTPose's attention against its bound: ``work_vitpose.
attention_bound_ms`` at the served chunk's batch, times the chunks of the
traced window, over the trace time of the fused attention kernels (their
names below: flash attention's ``flash_fwd``, the memory-efficient
kernel's ``fmha`` and cuDNN's, which on an H100 with torch 2.11 runs
``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_...``)."""
from portbench import work_vitpose

KERNELS = ("flash_fwd", "fmha", "sdpa")


def read(run):
    t, chunks = run.trace, run.counters.get("chunks", 0)
    if t is None or not chunks:
        return None
    busy = t.busy_s(KERNELS)
    if busy <= 0:
        return None
    batch = max(run.workload["batch_sizes"])
    precision = {"bfloat16": "bf16", "float32": "f32"}[run.workload["dtype"]]
    bound_s = chunks * work_vitpose.attention_bound_ms(
        run.config, batch, precision) / 1e3
    return 100.0 * bound_s / busy
