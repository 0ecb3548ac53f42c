"""Heatmap -> keypoint decoding and flip test-time augmentation (the port's
counterpart of ``argmax_decode``, ``heatmap_to_image_space`` and
``flip_average`` in ``bilinear_tpu/ops/decode.py``; ``softargmax`` and
``decode_to_normalized`` come with End2End), as torch ops on the heatmaps'
device.
"""
from __future__ import annotations

import torch

from bilinear_tpu_torch.ops.joints import MPII_FLIP_SWAP


def argmax_decode(heatmaps: torch.Tensor) -> torch.Tensor:
    """(..., J, H, W) -> (..., J, 2) heatmap-space (x, y) as f32: the flat
    argmax (the first of equal maxima), x = idx % W, y = idx // W
    (valid_hourglass.py:100-106)."""
    w = heatmaps.shape[-1]
    idx = heatmaps.flatten(-2).argmax(dim=-1)
    return torch.stack([idx % w, idx // w], dim=-1).float()


def heatmap_to_image_space(pose_xy: torch.Tensor, center_xy: torch.Tensor,
                           scale: torch.Tensor, size: int = 64
                           ) -> torch.Tensor:
    """center + (p - size/2) / size * scale * 200 (valid_hourglass.py:
    104-106); pose (..., J, 2), center (..., 2), scale (...)."""
    return center_xy[..., None, :] + (pose_xy - size // 2) / size * (
        scale[..., None, None] * 200.0)


def flip_average(heatmaps: torch.Tensor, flipped_heatmaps: torch.Tensor,
                 swap=MPII_FLIP_SWAP) -> torch.Tensor:
    """The straight (..., J, H, W) heatmaps averaged with the L/R-swapped,
    unflipped heatmaps of the mirrored input (valid_hourglass.py:88-96)."""
    idx = torch.as_tensor(swap, dtype=torch.long,
                          device=flipped_heatmaps.device)
    unflipped = flipped_heatmaps.index_select(-3, idx).flip(-1)
    return (heatmaps + unflipped) / 2.0
