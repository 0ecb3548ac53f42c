"""Offline annotation: one caller in a closed loop of
``End2EndServer.predict`` on ``frames_per_call`` u8 frames, a contiguous
run of a host pool of seeded frames that starts at a seeded multiple of
``start_step``, with the default full-frame box."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import pose, seeds


def setup(run) -> None:
    wl = run.workload
    server = pose.build(run)
    pool = seeds.frame_pool(run.seed, wl["pool_frames"])
    n = wl["frames_per_call"]
    for _ in range(2):  # the first builds the kernels
        server.predict(pool[:n])
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.state.update(server=server, pool=pool)


def starts(run, count: int) -> np.ndarray:
    """The first frame of each call, from the seed."""
    wl = run.workload
    step = wl["start_step"]
    slots = (wl["pool_frames"] - wl["frames_per_call"]) // step + 1
    return seeds.rng(run.seed, "calls").integers(0, slots, count) * step


def window(run, seconds: float) -> int:
    server, pool = run.state["server"], run.state["pool"]
    n = run.workload["frames_per_call"]
    firsts = starts(run, run.workload["max_calls"])
    answers = []
    ends = []
    t0 = time.perf_counter()
    while True:
        s = int(firsts[len(answers)])
        p2, p3 = server.predict(pool[s:s + n])
        answers.append((s, p2, p3))
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds or len(answers) == len(firsts):
            break
    window_s = ends[-1] - t0
    run.state["call_s"] = np.diff([t0] + ends)
    calls = len(answers)
    run.state["answers"] = answers
    run.attempted, run.failed = calls, 0
    per_call = -(-n // max(run.workload["batch_sizes"]))  # chunks a call
    run.counters.update(calls=calls, frames=calls * n,
                        chunks=calls * per_call)
    run.e2e["pose_frames_per_s"] = calls * n / window_s
    return calls


def release(run) -> None:
    run.state.pop("server", None)


def check(run) -> dict:
    """A seeded sample of the window's calls, every frame of each."""
    answers = run.state["answers"]
    k = min(run.workload["check_calls"], len(answers))
    pick = sorted(seeds.rng(run.seed, "check").choice(len(answers), k,
                                                      replace=False))
    n = run.workload["frames_per_call"]
    pool = run.state["pool"]
    frames = np.concatenate([pool[answers[i][0]:answers[i][0] + n]
                             for i in pick])
    p2 = np.concatenate([answers[i][1] for i in pick])
    p3 = np.concatenate([answers[i][2] for i in pick])
    out = pose.numbers(run, frames, p2, p3)
    q = np.percentile(run.state["call_s"], [10, 50, 90])
    out.update(call_p10_s=float(q[0]), call_p50_s=float(q[1]),
               call_p90_s=float(q[2]))
    return out
