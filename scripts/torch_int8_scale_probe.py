#!/usr/bin/env python3
"""The port's int8 scale probe (counterpart of benchmarks/int8_scale_probe.py's
main): where does K2's time over its bound go, scale work or products? One
JSON row per variant, in the probe's order, at its batch of 65536 rows on
seeded full-width weights:

    python3 scripts/torch_int8_scale_probe.py [ROOT]

- dynamic: K2 with one scale per group of 256, 512 or 1024 rows;
- fixed: K5's chain with one constant scale (no amax);
- mxu-bound: K5's chain with no scale math (a ceiling, not a result);
- production-entry: lifting_forward_int8 (dynamic, 512-row groups);
- production-static: calibrate_scales, then lifting_forward_int8 with them.

Each row holds poses/s and ms by CUDA events (chip_smoke.cuda_ms, plain
version - kernel - kernel - plain version), the plain version's ms, K2's
bound (the same products) and the card's name and power limit. Before
timing, every kernel the rows launch is held against its plain version
(chip_smoke.check_probe, phase 3c's checks); a miss stops the script. ROOT
(default: this checkout) is the root of a checkout that holds chip_smoke.py
and bilinear_tpu_torch/, so that two trees can be timed in one command.
Needs a CUDA device; imports nothing of JAX.
"""
import json
import os
import subprocess
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; the probe times the card's kernels")
        return 2
    import chip_smoke as cs
    from bilinear_tpu_torch.ops import _build
    from bilinear_tpu_torch.utils.weights import bilinear_to_jax

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["lifting_int8", "int8_scale_probe"])
    params, stats = bilinear_to_jax(cs.random_state_dict(cs.SEED))
    print(f"int8 scale probe of {root} on {card}", flush=True)
    cs.check_probe(params, stats)
    for row in cs.time_probe(params, stats, card, ns=(cs.PROBE_BATCH,)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
