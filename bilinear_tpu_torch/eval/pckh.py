"""PCKh@0.5 with flip test-time augmentation (counterpart of
``bilinear_tpu/eval/pckh.py``; the reference's protocol,
``valid_hourglass.py:50-142``), on the model's device:

- one eval-mode forward over ``[crops; hflip(crops)]`` (twice the
  pipeline's batch) instead of two;
- the straight heatmaps of the last stack averaged with the L/R-swapped,
  unflipped mirrored ones, argmax decode, image space via ``center + (p -
  32) / 64 * scale * 200``;
- a joint is a hit where dist / head <= 0.5; 14 joints are reported (pelvis
  and spine dropped by the ``[0:6] + [10:16] + [8:10]`` reorder), and an
  unannotated joint (NaN) counts in neither hits nor totals;
- padded slots of the last batch (``index < 0``) count nowhere.

Hits and totals are summed on the device and fetched once.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bilinear_tpu_torch.ops.affine import hflip
from bilinear_tpu_torch.ops.decode import argmax_decode, flip_average, \
    heatmap_to_image_space
from bilinear_tpu_torch.ops.joints import PCKH_KEYPOINTS, PCKH_REORDER
from bilinear_tpu_torch.train.hourglass import batch_tensors, \
    preprocess_batch


@torch.no_grad()
def pckh_counts(model: torch.nn.Module, batch: dict, heads: torch.Tensor,
                real: torch.Tensor, threshold: float = 0.5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-joint (hits, annotated) of one batch of device tensors, (14,)
    int64 each; the model must be in eval mode."""
    crops, _, _ = preprocess_batch(
        batch["images"], batch["centers"], batch["scales"],
        batch["keypoints"], batch["valid"], None)
    last = model(torch.cat([crops, hflip(crops)]))[-1]  # (2B, H, W, J)
    out, out_f = last.chunk(2)
    merged = flip_average(out.permute(0, 3, 1, 2), out_f.permute(0, 3, 1, 2))
    pose = heatmap_to_image_space(argmax_decode(merged), batch["centers"],
                                  batch["scales"])
    dists = (pose - batch["keypoints"]).square().sum(-1).sqrt()
    reorder = torch.as_tensor(PCKH_REORDER, dtype=torch.long,
                              device=dists.device)
    ratio = (dists / heads[:, None]).index_select(-1, reorder)
    annotated = ~torch.isnan(ratio) & real[:, None]
    hits = annotated & (ratio <= threshold)
    return hits.sum(0), annotated.sum(0)


@torch.no_grad()
def pckh_totals(model: torch.nn.Module, pipeline, threshold: float = 0.5
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-joint (hits, annotated) over a padded, un-augmented
    ``MPIIHostPipeline``, (14,) int64 numpy arrays in ``PCKH_KEYPOINTS``
    order. The model's train/eval mode is restored afterwards."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    hit = torch.zeros(len(PCKH_KEYPOINTS), dtype=torch.int64, device=dev)
    total = torch.zeros_like(hit)
    try:
        for batch in pipeline.epoch(0):
            b = batch_tensors(batch, dev)
            heads = torch.from_numpy(batch.heads).to(dev)
            real = torch.from_numpy(batch.index >= 0).to(dev)
            h, t = pckh_counts(model, b, heads, real, threshold)
            hit += h
            total += t
    finally:
        model.train(was_training)
    return hit.cpu().numpy(), total.cpu().numpy()


def pckh_scores(hit: np.ndarray, total: np.ndarray
                ) -> Tuple[Dict[str, float], float]:
    """({joint: PCKh %}, average %) of per-joint counts; NaN for a joint
    annotated nowhere."""
    per_joint = {
        name: float(hit[i] / total[i] * 100) if total[i] else float("nan")
        for i, name in enumerate(PCKH_KEYPOINTS)
    }
    return per_joint, float(hit.sum() / max(total.sum(), 1) * 100)


def evaluate_pckh(model: torch.nn.Module, pipeline, threshold: float = 0.5
                  ) -> Tuple[Dict[str, float], float]:
    """({joint: PCKh %}, average %) over ``pipeline``."""
    return pckh_scores(*pckh_totals(model, pipeline, threshold))
