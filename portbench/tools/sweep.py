"""The rate sweep of an open-loop cell, to find the highest rate the
program sustains without a growing backlog:

    python3 -m portbench.tools.sweep --workload pose_http.bf16 \\
        --seconds 10 --seed 7 RATE [RATE ...]

For each rate (requests/s) one fresh set-up and one window; prints the
latency median, 95th and 99th percentiles, the answers completed per second
of the window, how late the client sent, and the median latency of the
last fifth of the requests against the first fifth (a backlog that grows
through the window shows as a ratio well above 1)."""
from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("rates", type=float, nargs="+")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    for rate in args.rates:
        run, traffic = harness.setup_run(
            args.workload, args.seed, args.seconds, False,
            sizes={"workload": {"rate_per_s": rate}})
        harness.measure(run, traffic)
        traffic.release(run)
        got = run.state["got"]
        lat = (got["done"] - got["due"]) * 1e3
        fifth = max(1, len(lat) // 5)
        in_window = got["ok"] & (got["done"] <= args.seconds)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat),
            "failed": run.failed,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": run.e2e["pose_p95_ms"],
            "p99_ms": float(np.percentile(lat, 99)),
            "completed_per_s": float(in_window.sum() / args.seconds),
            "frames_per_s": float(got["sizes"][in_window].sum()
                                  / args.seconds),
            "late_max_ms": run.counters["late_max_ms"],
            "backlog_ratio": float(np.median(lat[-fifth:])
                                   / np.median(lat[:fifth])),
            "frames_per_dispatch": run.counters["rows_served"]
            / max(1, run.counters["batches"])}), flush=True)
        del run, traffic
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
