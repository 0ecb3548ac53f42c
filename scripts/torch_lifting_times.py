#!/usr/bin/env python3
"""Time the port's lifting kernels (K1, K2) of ANY checkout on one GPU, with
that checkout's own chip_smoke.time_kernels (CUDA events, plain-kernel-
kernel-plain turns, n = 256 and 65536, beside the bound, the plain version
and the cuBLAS chain):

    python3 scripts/torch_lifting_times.py [ROOT]

ROOT (default: this checkout) is the root of a checkout that holds
chip_smoke.py and bilinear_tpu_torch/, for instance a `git archive` of an
earlier commit unpacked beside this one: running both in one command on one
card is how a kernel's time before and after a change is compared. Imports
nothing of JAX.
"""
import os
import subprocess
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    import chip_smoke as cs
    from bilinear_tpu_torch.ops import _build
    from bilinear_tpu_torch.ops import lifting_int8 as pq
    from bilinear_tpu_torch.utils.weights import bilinear_to_jax

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["lifting", "lifting_int8"])
    params, stats = bilinear_to_jax(cs.random_state_dict(cs.SEED))
    wq = pq.prepare_weights_int8(params, stats, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    calib = torch.randn((4096, cs.IN_F), generator=gen, device="cuda")
    scales = pq.calibrate_scales(wq, calib)
    print(f"lifting kernels of {root} on {card}", flush=True)
    cs.time_kernels(params, stats, scales)
    return 0


if __name__ == "__main__":
    sys.exit(main())
