"""Heatmap -> keypoint decoding and flip test-time augmentation (the port's
counterpart of ``bilinear_tpu/ops/decode.py``: ``argmax_decode``,
``heatmap_to_image_space``, ``softargmax``, ``flip_average`` and
``decode_to_normalized``), as torch ops on the heatmaps' device.
"""
from __future__ import annotations

import torch

from bilinear_tpu_torch.ops.joints import H36M16_FROM_MPII, MPII_FLIP_SWAP


def argmax_decode(heatmaps: torch.Tensor) -> torch.Tensor:
    """(..., J, H, W) -> (..., J, 2) heatmap-space (x, y) as f32: the flat
    argmax (the first of equal maxima), x = idx % W, y = idx // W
    (valid_hourglass.py:100-106)."""
    w = heatmaps.shape[-1]
    idx = heatmaps.flatten(-2).argmax(dim=-1)
    return torch.stack([idx % w, idx // w], dim=-1).float()


def heatmap_to_image_space(pose_xy: torch.Tensor, center_xy: torch.Tensor,
                           scale: torch.Tensor, size=(64, 64)
                           ) -> torch.Tensor:
    """center + (p - n/2) / n * box per axis (valid_hourglass.py:104-106),
    ``size`` the heatmap's (H, W) and n its H for y and W for x: the box is
    ``scale * 200`` px tall and ``scale * 200 * W / H`` wide. Pose (..., J,
    2), center (..., 2), scale (...). A square heatmap takes the published
    single expression (the same bits, the same kernels)."""
    h, w = size
    tall = scale[..., None, None] * 200.0
    if h == w:
        return center_xy[..., None, :] + (pose_xy - h // 2) / h * tall
    x = center_xy[..., None, 0] + (pose_xy[..., 0] - w // 2) / w * (
        tall[..., 0] * (w / h))
    y = center_xy[..., None, 1] + (pose_xy[..., 1] - h // 2) / h * tall[
        ..., 0]
    return torch.stack([x, y], dim=-1)


def softargmax(heatmaps: torch.Tensor, temperature: float = 10.0
               ) -> torch.Tensor:
    """(..., H, W) -> (..., 2) soft (x, y): each axis's marginal sum scaled
    by ``temperature`` (x10, model/end2end.py:14), softmaxed, and its
    expectation over the index range; differentiable, batched.

    The exponent is clipped to [-80, 0] after the max is subtracted, as in
    the JAX package: it bounds exp's input on both sides, so garbage
    heatmaps (|value| ~ 1e7) give finite coordinates, not NaN; terms below
    exp(-80) add nothing to the expectation anyway."""
    h, w = heatmaps.shape[-2:]

    def expectation(marginal, n):
        x = temperature * marginal
        x = x - x.amax(dim=-1, keepdim=True)
        p = torch.exp(x.clamp(-80.0, 0.0))
        p = p / p.sum(dim=-1, keepdim=True)
        idx = torch.arange(n, dtype=torch.float32, device=heatmaps.device)
        return (p * idx).sum(dim=-1)

    return torch.stack([expectation(heatmaps.sum(dim=-2), w),
                        expectation(heatmaps.sum(dim=-1), h)], dim=-1)


def flip_average(heatmaps: torch.Tensor, flipped_heatmaps: torch.Tensor,
                 swap=MPII_FLIP_SWAP) -> torch.Tensor:
    """The straight (..., J, H, W) heatmaps averaged with the L/R-swapped,
    unflipped heatmaps of the mirrored input (valid_hourglass.py:88-96)."""
    idx = torch.as_tensor(swap, dtype=torch.long,
                          device=flipped_heatmaps.device)
    unflipped = flipped_heatmaps.index_select(-3, idx).flip(-1)
    return (heatmaps + unflipped) / 2.0


def decode_to_normalized(heat_last: torch.Tensor, centers: torch.Tensor,
                         scales: torch.Tensor, mean_part: torch.Tensor,
                         std_part: torch.Tensor, temperature: float = 10.0,
                         size=(64, 64)):
    """The detector -> lifting glue of End2End: softargmax (x10) -> image
    space -> MPII -> H36M-16 joint order (the nose slot deleted,
    ``H36M16_FROM_MPII``) -> z-score with the H36M train-split part
    statistics.

    ``heat_last``: (B, H, W, J) f32, the last stack of the port's detector
    output (S, B, H, W, J), which is the JAX package's layout too; centers
    (B, 2), scales (B,) and the statistics (32,) on its device; ``size``
    the (H, W) the detector decodes with (its ``heatmap_size``: the
    published 64 x 64 for a hourglass whatever its input, as in JAX;
    ViTPose's 64 x 48), each axis mapped by its own. Returns (pose_img (B,
    16, 2) in MPII order, normalized (B, 32))."""
    pose_hm = softargmax(heat_last.permute(0, 3, 1, 2), temperature)
    pose_img = heatmap_to_image_space(pose_hm, centers, scales, size)
    idx = torch.as_tensor(H36M16_FROM_MPII, dtype=torch.long,
                          device=pose_img.device)
    flat = pose_img.index_select(-2, idx).reshape(pose_img.shape[0], -1)
    return pose_img, (flat - mean_part) / std_part
