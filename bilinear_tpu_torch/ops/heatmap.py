"""Gaussian target heatmaps (counterpart of ``bilinear_tpu/ops/heatmap.py``;
plain torch ops, as they are XLA, not Pallas, in the JAX package).

Parity contract with the reference's ``draw_heatmap``: centres are
truncated to integers before stamping; the patch is a (6 sigma + 1)^2
window of ``exp(-0.5 (dy^2 + dx^2) / (0.25 (6 sigma + 1))^2)``; joints whose
float coordinates fall outside [0, size) are skipped.
"""
from __future__ import annotations

import math

import torch


def render_heatmaps(coords_xy: torch.Tensor, valid: torch.Tensor,
                    size: int = 64, sigma: int = 1) -> torch.Tensor:
    """(..., J, 2) heatmap-space (x, y) and (..., J) validity -> (..., J,
    size, size) f32 heatmaps."""
    pad = 3 * sigma
    denom = 0.25 * (6 * sigma + 1)
    x0 = torch.floor(coords_xy[..., 0]).to(torch.int32)
    y0 = torch.floor(coords_xy[..., 1]).to(torch.int32)
    in_bounds = ((coords_xy[..., 0] >= 0) & (coords_xy[..., 1] >= 0)
                 & (coords_xy[..., 0] < size) & (coords_xy[..., 1] < size))
    keep = valid & in_bounds
    idx = torch.arange(size, dtype=torch.int32, device=coords_xy.device)
    dy = idx[:, None] - y0[..., None, None]  # (..., J, size, size)
    dx = idx[None, :] - x0[..., None, None]
    window = (dy.abs() <= pad) & (dx.abs() <= pad)
    g = torch.exp(-0.5 * (dy.float() ** 2 + dx.float() ** 2) / denom ** 2)
    return torch.where(window & keep[..., None, None], g, 0.0)


def keypoints_to_heatmap_space(keypoints_xy: torch.Tensor,
                               center_xy: torch.Tensor, scale,
                               rotate_deg=0.0, size: int = 64
                               ) -> torch.Tensor:
    """Image space -> heatmap space: p = (kp - center) * size / (200 scale),
    rotated by the augmentation angle [x' = sin y + cos x; y' = cos y -
    sin x], then + size // 2."""
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=keypoints_xy.device)
    rot = torch.as_tensor(rotate_deg, dtype=torch.float32,
                          device=keypoints_xy.device) * (math.pi / 180.0)
    p = (keypoints_xy - center_xy[..., None, :]) * (
        size / (200.0 * scale[..., None, None]))
    cos, sin = torch.cos(rot), torch.sin(rot)
    x = sin[..., None] * p[..., 1] + cos[..., None] * p[..., 0]
    y = cos[..., None] * p[..., 1] - sin[..., None] * p[..., 0]
    return torch.stack([x, y], dim=-1) + size // 2
