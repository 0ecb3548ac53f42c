"""One run of one cell: the manifest, the card, set-up, the measured window,
the per-layer readers, the comparison with the reference, the result line.

A cell's traffic module (``traffic/<traffic>.py``, named by its workload
file) has four functions:

- ``setup(run)`` builds the system under test from the seed and warms up
  the cell's shapes;
- ``window(run, seconds)`` drives the traffic for ``seconds``, fills
  ``run.e2e``, ``run.counters``, ``run.attempted`` and ``run.failed``, and
  returns the calls it made (None for an open loop);
- ``release(run)`` frees the program's state, keeping its answers;
- ``check(run)`` returns ``{number: value}``, what the reference makes of
  the answers.

A per-layer metric is ``metrics/<name>.py``, whose ``read(run)`` returns
its value, or None where it finds nothing to read.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "bilinear_tpu")


class Run:
    """What one run knows: its cell, and what its traffic module and the
    trace found."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 workload: dict, config: dict, device, control: bool = False):
        self.name, self.seed, self.seconds = name, seed, seconds
        self.trace_on = trace
        self.workload, self.config = workload, config
        self.device = device
        self.control = control  # the program's lower-precision path
        self.state: dict = {}
        self.e2e: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.trace = None


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no BENCHMARK.json at {ROOT}")
    return load_json(path)


def cell(bench: dict, name: str):
    """(its entry in BENCHMARK.json or None, the workload's file, its
    configuration's file)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    wl = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    cfg = load_json(os.path.join(HERE, "configs", f"{wl['config']}.json"))
    return entry, wl, cfg


def metrics_of(bench: dict, name: str, section: str) -> List[dict]:
    """The metrics of ``section`` that this cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def traffic_module(wl: dict):
    return importlib.import_module(f"portbench.traffic.{wl['traffic']}")


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {value, limit}}) over the numbers that have a
    limit; a number that is missing or not finite fails."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        v = None if v is None else float(v)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v if v is None or math.isfinite(v) else None,
                     "limit": limit}
    return ok, out


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def setup_run(name: str, seed: int, seconds: float, trace: bool,
              control: bool = False, device=None, sizes=None) -> tuple:
    """(Run, its traffic module), set up: the system built and warmed.
    ``control`` serves the program's lower-precision path; ``device`` and
    ``sizes`` (``{"config": {...}, "workload": {...}}`` updates) are for
    the CPU tests' small runs."""
    import torch

    bench = manifest()
    _, wl, cfg = cell(bench, name)
    for part, base in (("config", cfg), ("workload", wl)):
        base.update((sizes or {}).get(part, {}))
    # f32 is full f32 on both sides: the port's CLIs turn TF32 off first.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(name, seed, seconds, trace, wl, cfg,
              torch.device(device or "cuda"), control)
    traffic = traffic_module(wl)
    traffic.setup(run)
    return run, traffic


def measure(run: Run, traffic) -> None:
    """The measured window, traced where asked."""
    seconds = run.seconds
    if run.trace_on:
        from portbench.trace import traced

        seconds = min(seconds, run.workload.get("trace_seconds", seconds))
        _, run.trace = traced(lambda: traffic.window(run, seconds))
    else:
        traffic.window(run, seconds)


def main(args, t_start: float) -> int:
    import torch

    bench = manifest()
    entry, wl, _ = cell(bench, args.workload)
    if entry is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA "
              f"card(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    run, traffic = setup_run(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    measure(run, traffic)
    peak = max(torch.cuda.max_memory_allocated(d)
               for d in range(entry["chips"]))
    metrics = {}
    if run.trace_on:
        for m in metrics_of(bench, args.workload, "per_layer"):
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, args.workload, "end_to_end"):
            v = setup_s if m["name"] == "setup_s" else run.e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    traffic.release(run)
    gc.collect()
    torch.cuda.empty_cache()
    numbers = traffic.check(run)
    correct, checks = judge(numbers, wl["limits"])
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {bad}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["card"] = power_limit()
    result["numbers"] = {k: v for k, v in numbers.items() if k not in checks}
    result["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
