"""Live clients of one daemon: ``/v1/pose`` on ``PoseHTTPServer`` at its
defaults, under an open loop of Poisson arrivals at a fixed rate from a
client process of the benchmark's own (``http_client.py``), with as many
connections as it takes never to hold a request back. Requests carry 1, 8
or 16 u8 frames as .npz."""
from __future__ import annotations

import multiprocessing
import time

import numpy as np
import torch

from portbench import pose, seeds
from portbench.traffic import http_client

START_DELAY_S = 0.1


def params(run) -> dict:
    wl = run.workload
    return {k: wl[k] for k in ("rate_per_s", "sizes", "size_probs",
                               "pool_frames", "connections")}


def setup(run) -> None:
    """The daemon, warmed, and the client process, its bodies made."""
    from bilinear_tpu_torch.serving_http import PoseHTTPServer

    server = pose.build(run)
    daemon = PoseHTTPServer(end2end=server, **run.workload["daemon"])
    daemon.warm(("uint8",))  # each End2End batch size, the first builds
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    daemon.start()
    run.state.update(daemon=daemon, server=server)
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=http_client.main,
                       args=(child, daemon.port, run.seed, params(run)),
                       daemon=True)
    proc.start()
    run.state.update(client=proc, pipe=parent)
    if parent.recv() != "ready":
        raise RuntimeError("the HTTP client did not start")


def window(run, seconds: float):
    """Let the client send for ``seconds``, and wait for every answer (up
    to a minute past the window)."""
    daemon, parent = run.state["daemon"], run.state["pipe"]
    due, sizes, _ = http_client.schedule(run.seed, params(run), seconds)
    k = min(run.workload["check_requests"], len(due))
    keep = sorted(seeds.rng(run.seed, "check").choice(
        len(due), k, replace=False).tolist())
    b = daemon.pose_batcher
    before = (b.rows_served, b.batches_dispatched, b.dispatch_seconds)
    parent.send((time.monotonic() + START_DELAY_S, seconds, keep))
    got = parent.recv()
    stop_client(run)
    after = (b.rows_served, b.batches_dispatched, b.dispatch_seconds)
    latency_ms = (got["done"] - got["due"]) * 1e3
    run.state["got"], run.state["keep"] = got, keep
    run.attempted = len(due)
    run.failed = int((~got["ok"]).sum())
    run.counters.update(
        requests=len(due), frames=int(sizes.sum()),
        rows_served=after[0] - before[0],
        batches=after[1] - before[1],
        dispatch_s=after[2] - before[2],
        late_max_ms=float(np.nanmax(got["sent"] - got["due"]) * 1e3))
    run.e2e["pose_p95_ms"] = http_client.percentile(latency_ms.tolist(), 95)
    return None


def stop_client(run) -> None:
    proc = run.state.pop("client", None)
    if proc is None:
        return
    proc.join(timeout=30)
    if proc.is_alive():
        proc.kill()
        proc.join()


def release(run) -> None:
    stop_client(run)
    daemon = run.state.pop("daemon", None)
    if daemon is not None:
        daemon.stop()
    run.state.pop("server", None)


def check(run) -> dict:
    """The answers of a seeded sample of requests, as the client received
    them, against the reference on their frames."""
    got = run.state["got"]
    pool = seeds.frame_pool(run.seed, run.workload["pool_frames"])
    ids = sorted(got["answers"])
    missing = float(len(run.state["keep"]) - len(ids))
    if not ids:
        return {"missing_answers": missing}
    frames = np.concatenate([pool[got["firsts"][i]:got["firsts"][i]
                                  + got["sizes"][i]] for i in ids])
    p2 = np.concatenate([got["answers"][i][0] for i in ids])
    p3 = np.concatenate([got["answers"][i][1] for i in ids])
    out = pose.numbers(run, frames, p2, p3)
    out["requests_compared"] = float(len(ids))
    out["missing_answers"] = missing
    out["late_max_ms"] = run.counters["late_max_ms"]
    return out
