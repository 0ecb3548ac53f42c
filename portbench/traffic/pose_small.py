"""Live annotation: one caller in a closed loop of
``End2EndServer.predict`` on calls of ``sizes`` frames (1, 8 and 16: a
webcam's single frame, the HTTP batcher's dispatches) in that fixed cycle,
each a run of a host pool of seeded C-contiguous u8 frames from a seeded
multiple of ``start_step``, with the default full-frame box. Every call is
one unpadded chunk of the cell's ``batch_sizes``, so the per-chunk
readers read each call. The window ends on a whole cycle, and returns the
cycles it made: each kernel comes a whole number of times a cycle, not a
call, since the calls differ in batch."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import pose, seeds


def setup(run) -> None:
    wl = run.workload
    server = pose.build(run)
    pool = np.ascontiguousarray(seeds.frame_pool(run.seed,
                                                 wl["pool_frames"]))
    for _ in range(2):  # the first builds the kernels
        for n in wl["sizes"]:
            server.predict(pool[:n])
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.state.update(server=server, pool=pool)


def starts(run, count: int) -> np.ndarray:
    """The first frame of each call, from the seed (every call fits the
    pool from any of them)."""
    wl = run.workload
    step = wl["start_step"]
    slots = (wl["pool_frames"] - max(wl["sizes"])) // step + 1
    return seeds.rng(run.seed, "calls").integers(0, slots, count) * step


def window(run, seconds: float) -> int:
    server, pool = run.state["server"], run.state["pool"]
    sizes = run.workload["sizes"]
    firsts = starts(run, run.workload["max_calls"])
    answers = []
    ends = []
    t0 = time.perf_counter()
    while True:
        s = int(firsts[len(answers)])
        n = sizes[len(answers) % len(sizes)]
        p2, p3 = server.predict(pool[s:s + n])
        answers.append((s, n, p2, p3))
        ends.append(time.perf_counter())
        if len(answers) % len(sizes) == 0 and (
                ends[-1] - t0 >= seconds
                or len(answers) + len(sizes) > len(firsts)):
            break
    window_s = ends[-1] - t0
    run.state["call_s"] = np.diff([t0] + ends)
    calls = len(answers)
    frames = sum(a[1] for a in answers)
    run.state["answers"] = answers
    run.attempted, run.failed = calls, 0
    run.counters.update(calls=calls, frames=frames, chunks=calls)
    run.e2e["pose_frames_per_s"] = frames / window_s
    return calls // len(sizes)


def release(run) -> None:
    run.state.pop("server", None)


def check(run) -> dict:
    """A seeded sample of the window's calls that holds at least
    ``check_frames`` frames (every call, if the window holds fewer),
    every frame of each, against the reference as ``pose_bulk.bf16``'s
    check compares them."""
    answers = run.state["answers"]
    order = seeds.rng(run.seed, "check").permutation(len(answers))
    pick, held = [], 0
    for i in order:
        if held >= run.workload["check_frames"]:
            break
        pick.append(int(i))
        held += answers[i][1]
    pick.sort()
    pool = run.state["pool"]
    frames = np.concatenate([pool[answers[i][0]:answers[i][0]
                                  + answers[i][1]] for i in pick])
    p2 = np.concatenate([answers[i][2] for i in pick])
    p3 = np.concatenate([answers[i][3] for i in pick])
    out = pose.numbers(run, frames, p2, p3)
    q = np.percentile(run.state["call_s"], [10, 50, 90])
    out.update(call_p10_s=float(q[0]), call_p50_s=float(q[1]),
               call_p90_s=float(q[2]))
    return out
