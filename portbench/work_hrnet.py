"""The work of End2End with an HRNet detector, from its configuration's
shapes (``reference/hrnet_layout.py``): every conv's multiply-adds at its
output resolution, and the lifter's (``work.lifter_macs``). It reads the
same whatever kernel implements the work."""
from __future__ import annotations

import math

from portbench import work
from portbench.reference import hrnet_layout


def detector_macs(cfg: dict) -> int:
    """Multiply-adds of one frame through HRNet's convolutions, at the
    configuration's ``image_size`` (width, height, as the yaml gives it)."""
    w, h = cfg["image_size"]
    total = 0
    for _, kind, shape, stride in hrnet_layout.walk(cfg):
        if stride is not None:
            total += (h // stride) * (w // stride) * math.prod(shape)
    return total


def hrnet_macs(cfg: dict) -> int:
    """Multiply-adds of one frame through End2End: the detector's convs and
    the lifter."""
    return detector_macs(cfg) + work.lifter_macs(cfg["lifter"])


def parameters(cfg: dict) -> int:
    """The detector's trained parameters, counted from the layout: conv
    kernels and biases, BN scales and biases."""
    total = 0
    for _, kind, shape, _ in hrnet_layout.walk(cfg):
        if kind == "bn":
            total += 2 * shape[0]
        else:
            total += math.prod(shape) + (shape[-1] if kind == "conv_b"
                                         else 0)
    return total
