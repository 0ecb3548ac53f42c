"""Bulk lifting of a dataset's detections: one caller in a closed loop of
``LiftingServer.lift`` on consecutive ``rows_per_call``-pose slices of a
device-resident pool of seeded image-space poses. The answers stay on the
card; the window ends in a synchronise. A seeded set of calls keeps its
answers for the check."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import seeds
from portbench.reference import model as ref
from portbench.reference.weights import lifter_pool, lifter_weights


def setup(run) -> None:
    from bilinear_tpu_torch.serving import LiftingServer

    wl = run.workload
    pool = lifter_pool(run.seed, wl["pool_rows"], run.device)
    w, stats = lifter_weights(run.config, run.seed, run.device, pool)
    tree = w.tree()

    def host(t):
        return t.detach().cpu().numpy()

    server = LiftingServer(
        tree["params"], tree["batch_stats"], host(stats.mean_part),
        host(stats.std_part), host(stats.mean_s), host(stats.std_s),
        dtype=getattr(torch, wl["dtype"]),
        quantize="int8" if run.control else None, device=run.device)
    n = wl["rows_per_call"]
    for _ in range(2):  # the first builds the kernel
        server.lift(pool[:n].view(-1, 16, 2))
    sync(run)
    run.state.update(server=server, pool=pool, weights=w, stats=stats)


def sync(run) -> None:
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def window(run, seconds: float) -> int:
    wl = run.workload
    server, pool = run.state["server"], run.state["pool"]
    n = wl["rows_per_call"]
    slices = wl["pool_rows"] // n
    keep = set(seeds.rng(run.seed, "check").choice(
        wl["check_call_range"], wl["check_calls"], replace=False).tolist())
    kept = {}
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = calls % slices
        out = server.lift(pool[i * n:(i + 1) * n].view(-1, 16, 2))
        if calls in keep:
            kept[calls] = out
        calls += 1
    sync(run)
    window_s = time.perf_counter() - t0
    run.state["kept"] = kept
    run.attempted, run.failed = calls, 0
    run.counters.update(calls=calls, poses=calls * n)
    run.e2e["lift_poses_per_s"] = calls * n / window_s
    return calls


def release(run) -> None:
    run.state.pop("server", None)


def check(run) -> dict:
    """Every pose of the kept calls against the reference in f32."""
    wl = run.workload
    n = wl["rows_per_call"]
    slices = wl["pool_rows"] // n
    pool, w, stats = run.state["pool"], run.state["weights"], \
        run.state["stats"]
    sq = 0.0
    worst = 0.0
    count = 0
    spread = []
    with torch.no_grad():
        for k, out in sorted(run.state["kept"].items()):
            i = k % slices
            r = ref.lift(w.net, stats, pool[i * n:(i + 1) * n])
            g = out.double() - r.double()
            sq += float((g ** 2).sum())
            worst = max(worst, float(g.abs().max()))
            count += g.numel()
            spread.append(float(r.std(dim=0).mean()))
    if not count:
        return {}
    return {"lift_rms_mm": (sq / count) ** 0.5, "lift_max_mm": worst,
            "ref_lift_spread_mm": float(np.mean(spread)),
            "poses_compared": float(count // 48)}
