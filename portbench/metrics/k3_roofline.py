"""K3 (the fused ResModule, eval mode) against its bound: the summed
``res_bound_ms`` of the forward's ResModules at the served chunk's batch,
times the chunks of the traced window, over the trace time of the kernels
of ``csrc/resmodule.cu`` (their names below)."""
from portbench import work

KERNELS = ("gemm_tc_k", "conv_tc_k", "gemm_simt_k", "wgrad_tc_k",
           "wgrad_simt_k", "stats_partial_k", "stats_finish_k",
           "pair_finish_k", "rank_merge_k", "rank_sum_k", "finish_grads_k",
           "pack_k", "bn_bwd_k")


def read(run):
    t, chunks = run.trace, run.counters.get("chunks", 0)
    if t is None or not chunks:
        return None
    busy = t.busy_s(KERNELS)
    if busy <= 0:
        return None
    batch = max(run.workload["batch_sizes"])
    precision = {"bfloat16": "bf16", "float32": "f32"}[run.workload["dtype"]]
    bound_s = chunks * work.detector_res_bound_ms(
        run.config, batch, "fwd", precision) / 1e3
    return 100.0 * bound_s / busy
