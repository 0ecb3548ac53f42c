"""Offline annotation of person crops with a transformer detector:
``pose_bulk``'s closed loop of ``End2EndServer.predict`` (its ``window``
and ``release``) on a host pool of C-contiguous u8 crops at the
configuration's ``image_size`` (the central 192 columns of the seeded
256 x 256 frames), against ViTPose and its reference
(``pose_vitpose.py``)."""
from __future__ import annotations

import numpy as np
import torch

from portbench import pose_vitpose, seeds
from portbench.traffic.pose_bulk import release, window

__all__ = ["setup", "window", "release", "check"]


def setup(run) -> None:
    wl = run.workload
    server = pose_vitpose.build(run)
    pool = pose_vitpose.frame_pool(run.config, run.seed, wl["pool_frames"])
    n = wl["frames_per_call"]
    for _ in range(2):  # the first loads cuBLAS's and cuDNN's kernels
        server.predict(pool[:n])
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.state.update(server=server, pool=pool)


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
    out = pose_vitpose.numbers(run, frames, p2, p3)
    q = np.percentile(run.state["call_s"], [10, 50, 90])
    out.update(call_p10_s=float(q[0]), call_p50_s=float(q[1]),
               call_p90_s=float(q[2]))
    return out
