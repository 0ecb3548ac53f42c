"""MPJPE evaluation, the reference protocol (counterpart of
``bilinear_tpu/eval/mpjpe.py``).

Eval-mode forward; un-normalize prediction and ground truth with the TRAIN
split's mean/std; per-sample distance = sum over the 16 joints of the
per-joint Euclidean norm (mm); accumulate per action with sub-action
suffixes merged (``Walking_1`` -> ``Walking``, done by ``load_h36m``);
per-action MPJPE = total / (count * 16); overall = grand total / (N * 16).

The forward is a function argument, so one split can score the served
kernel path and the plain path alike; ``make_mpjpe_fn`` makes one from a
model (the counterpart of the JAX package's ``make_mpjpe_fn``). Rows go
through in fixed chunks (8192 by default); the last chunk is zero-padded
and its padding rows are dropped before scoring.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from bilinear_tpu_torch.data.h36m import NUM_JOINTS, H36MSplit


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def evaluate_mpjpe(
    forward: Callable, split: H36MSplit, chunk: int = 8192
) -> Tuple[Dict[str, float], float]:
    """``forward``: (chunk, 32) normalized f32 rows (numpy) -> (chunk, 48)
    normalized predictions (numpy or tensor). Returns
    ({action: MPJPE_mm}, overall MPJPE_mm)."""
    n = len(split)
    num_actions = len(split.action_names)
    dist_sum = np.zeros(num_actions, np.float64)
    count = np.zeros(num_actions, np.float64)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        x = np.zeros((chunk, split.part.shape[1]), np.float32)
        x[: stop - start] = split.part[start:stop]
        pred = _numpy(forward(x))[: stop - start]
        pred_mm = pred * split.std_s + split.mean_s
        gt_mm = split.s[start:stop] * split.std_s + split.mean_s
        d = np.sqrt(np.square(
            pred_mm.reshape(-1, NUM_JOINTS, 3) - gt_mm.reshape(-1, NUM_JOINTS, 3)
        ).sum(axis=2)).sum(axis=1)
        actions = split.actions[start:stop]
        np.add.at(dist_sum, actions, d)
        np.add.at(count, actions, 1.0)

    per_action = {
        name: float(dist_sum[i] / (count[i] * NUM_JOINTS))
        for i, name in enumerate(split.action_names)
        if count[i] > 0
    }
    overall = float(dist_sum.sum() / (count.sum() * NUM_JOINTS))
    return per_action, overall


def make_mpjpe_fn(model: torch.nn.Module) -> Callable:
    """The forward for ``evaluate_mpjpe`` of a ``BilinearUnit``: its
    eval-mode forward under ``no_grad`` on the model's device (numpy rows
    in, f32 tensor out). The model's train/eval mode is restored after each
    call."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def forward(x) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            return model(torch.as_tensor(x, device=dev)).float()
        finally:
            model.train(was_training)

    return forward
