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
bound (the same products) and the card's name and power limit. Then one
JSON row per traced call: fixed, mxu-bound and production-static at n =
256 and 65536 by a torch.profiler trace (kernels_in_order), each device
kernel of a call in launch order with its microseconds. Last, K1 (bf16,
f32) and K2 (dynamic, static) at n = 256 and 65536 as
chip_smoke.time_kernels times them (phase 5): their code shares K5's
header. Before timing, every kernel the rows launch is held against its
plain version (chip_smoke.check_probe, phase 3c's checks); a miss stops
the script. ROOT
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
    _build.build_all(["lifting", "lifting_int8", "int8_scale_probe"])
    params, stats = bilinear_to_jax(cs.random_state_dict(cs.SEED))
    print(f"int8 scale probe of {root} on {card}", flush=True)
    cs.check_probe(params, stats)
    for row in cs.time_probe(params, stats, card, ns=(cs.PROBE_BATCH,)):
        print(json.dumps(row), flush=True)
    for row in trace_rows(cs, params, stats, card):
        print(json.dumps(row), flush=True)
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    wq = pq.prepare_weights_int8(params, stats, device="cuda")
    scales = pq.calibrate_scales(wq, torch.randn(
        (cs.PROBE_BATCH, cs.IN_F), generator=gen, device="cuda"))
    for name, at_n in cs.time_kernels(params, stats, scales).items():
        for n, row in at_n.items():
            print(json.dumps({"kernel": name, "n": n, "card": card, **row}),
                  flush=True)
    return 0


def kernels_in_order(fn, calls=3):
    """Each device kernel of one call of ``fn`` in launch order: [(name, us
    averaged over ``calls`` traced calls)], from a torch.profiler trace
    (one call first, in the warm-up window; retried while the profiler
    drops records and the kernels do not come out a whole number of
    calls)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(6):
        pad = 0.02 * 2 ** attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not e.name.startswith("Memcpy")),
                        key=lambda e: e.time_range.start)
        if events and len(events) % calls == 0:
            per = len(events) // calls
            return [(events[i].name, sum(events[i + c * per].time_range
                                         .elapsed_us()
                                         for c in range(calls)) / calls)
                    for i in range(per)]
    raise RuntimeError("the profiler keeps dropping records")


def trace_rows(cs, params, stats, card):
    """fixed, mxu-bound and production-static, each device kernel of a call
    in launch order by a profiler trace, at n = 256 and the probe's
    batch."""
    import torch
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    wq = pq.prepare_weights_int8(params, stats, device="cuda")
    x_all = torch.randn((cs.PROBE_BATCH, cs.IN_F), generator=gen,
                        device="cuda")
    scales = pq.calibrate_scales(wq, x_all)
    rows = []
    for n in (256, cs.PROBE_BATCH):
        calls = {v: k for v, _, k, _ in cs.probe_calls(wq, scales, x_all[:n])}
        for variant in ("fixed", "mxu-bound", "production-static"):
            kernels = kernels_in_order(calls[variant])
            rows.append({
                "trace": variant, "n": n, "card": card,
                "ms": sum(us for _, us in kernels) / 1e3,
                "device_kernels_per_call": len(kernels),
                "kernels": [{"name": cs._short(k), "us": us}
                            for k, us in kernels]})
    return rows


if __name__ == "__main__":
    sys.exit(main())
