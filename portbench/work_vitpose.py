"""The work of End2End with a ViTPose detector, from its configuration's
shapes (``reference/vitpose_layout.py``): each Linear's multiply-adds over
the tokens, attention's two products, the patch embedding, the head's
deconvolutions (counted over their input positions, as ``FlopCounterMode``
counts a transposed conv) and ``final_layer``, and the lifter's
(``work.lifter_macs``). It reads the same whatever kernel implements the
work. ``attention_bound_ms`` is the least time attention could take."""
from __future__ import annotations

import math

from portbench import work
from portbench.reference import vitpose_layout


def tokens(cfg: dict) -> int:
    rows, cols = vitpose_layout.grid(cfg)
    return rows * cols


def detector_macs(cfg: dict) -> int:
    """Multiply-adds of one frame through ViTPose."""
    b = cfg["backbone"]
    t, c = tokens(cfg), b["embed_dim"]
    rows, cols = vitpose_layout.grid(cfg)
    total = 0
    at = rows * cols  # the map's positions the next layer reads
    for _, kind, shape in vitpose_layout.detector_leaves(cfg):
        if kind == "dense":
            total += t * math.prod(shape)
        elif kind == "deconv":
            total += at * math.prod(shape)
            at *= 4  # stride 2
        elif kind == "conv_b":
            total += at * math.prod(shape)  # the patch conv: one a token
    return total + b["depth"] * 2 * t * t * c


def vitpose_macs(cfg: dict) -> int:
    """Multiply-adds of one frame through End2End: the detector and the
    lifter."""
    return detector_macs(cfg) + work.lifter_macs(cfg["lifter"])


def parameters(cfg: dict) -> int:
    """The detector's trained parameters, counted from the layout: kernels
    and biases, ``pos_embed``, LayerNorm and BN scales and biases."""
    total = 0
    for _, kind, shape in vitpose_layout.detector_leaves(cfg):
        if kind in ("bn", "ln"):
            total += 2 * shape[0]
        else:
            total += math.prod(shape) + (shape[-1] if kind in (
                "conv_b", "dense") else 0)
    return total


def attention_bound_ms(cfg: dict, batch: int,
                       precision: str = "bf16") -> float:
    """Least time (ms) of attention over a chunk of ``batch`` frames, every
    block: the larger of its two products' operations (4 B T^2 C a block)
    at the precision's peak and the bytes of Q, K, V and O (4 B T C values)
    at HBM bandwidth, summed over the blocks."""
    b = cfg["backbone"]
    t, c = tokens(cfg), b["embed_dim"]
    ops_s = 4 * batch * t * t * c / work.PEAK_FLOPS[precision]
    bytes_s = 4 * batch * t * c * work.ITEMSIZE[precision] \
        / work.HBM_BYTES_PER_S
    return b["depth"] * max(ops_s, bytes_s) * 1e3
