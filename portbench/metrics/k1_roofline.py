"""K1 (the lifting kernel of ``csrc/lifting.cu``) against its bound at the
call's rows (``work.lift_bound_ms``), per call of the traced window."""
from portbench import work

KERNELS = ("gemm_wgmma", "lifting_chain_wgmma", "gemm_f32")


def read(run):
    t, calls = run.trace, run.counters.get("calls", 0)
    if t is None or not calls:
        return None
    busy = t.busy_s(KERNELS)
    if busy <= 0:
        return None
    precision = {"bfloat16": "bf16", "float32": "f32"}[run.workload["dtype"]]
    bound_ms, _ = work.lift_bound_ms(run.config, precision,
                                     run.workload["rows_per_call"])
    return 100.0 * calls * bound_ms / 1e3 / busy
