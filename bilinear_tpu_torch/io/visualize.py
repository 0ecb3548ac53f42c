"""Heatmap overlays for TensorBoard (counterpart of
``bilinear_tpu/io/visualize.py::heatmap_overlay``): the last stack's
heatmaps, max over joints, through a colour-gradient table, upscaled to the
image and alpha-blended over it."""
from __future__ import annotations

import numpy as np
import torch

# MSDN 'Heat Map Color Gradients': navy, blue, green, yellow, red.
COLOR_SPECTRUM = np.asarray(
    [[0.0, 0.0, 0.5], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0],
     [1.0, 0.0, 0.0]], np.float32)


def colorize(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, J, H, W) -> (B, 3, H, W) RGB."""
    lut = torch.as_tensor(COLOR_SPECTRUM, device=heatmaps.device)
    n = lut.shape[0]
    index = torch.clamp(heatmaps.amax(dim=1) * (n - 1), 0.0, n - 1)
    lo = torch.floor(index).long()
    hi = torch.ceil(index).long()
    rate = (index - lo)[..., None]
    rgb = lut[lo] * (1 - rate) + lut[hi] * rate
    return rgb.permute(0, 3, 1, 2)


def heatmap_overlay(images_nhwc: torch.Tensor, heatmaps_sbhwj: torch.Tensor
                    ) -> np.ndarray:
    """(B, H, W, 3) images and (S, B, h, w, J) heatmaps -> (B, 3, H, W),
    half and half."""
    colored = colorize(heatmaps_sbhwj[-1].permute(0, 3, 1, 2))
    factor = images_nhwc.shape[1] // colored.shape[-1]
    colored = colored.repeat_interleave(factor, dim=-2) \
        .repeat_interleave(factor, dim=-1)
    images = images_nhwc.permute(0, 3, 1, 2)
    return (colored * 0.5 + images * 0.5).cpu().numpy()
