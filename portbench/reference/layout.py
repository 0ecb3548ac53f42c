"""The leaves of the two models, in the layout of the JAX package's
``.save`` trees, which the port's servers take.

A leaf is ``(path, kind, shape)``:

- ``conv``: ``kernel`` (kh, kw, in, out) and ``bias`` (out,);
- ``dense``: ``kernel`` (in, out) and ``bias`` (out,);
- ``bn``: parameters ``scale``, ``bias`` (C,) and statistics ``mean``,
  ``var`` (C,) and ``count`` (a scalar).

The torch7 detector follows pose-hg-train's ``hg.lua`` with one ResModule
per slot: a stem (conv 7x7/2, BN, ReLU, Res(64, 128), max-pool,
Res(128, 128), Res(128, F)), then per stack a depth-``depth`` hourglass,
``lin`` (1x1 conv, BN, ReLU), the heatmap conv, and for every stack but the
last the two feedback convs. A ResModule is ``conv_skip`` (only where the
channel count changes) and BN, ReLU, 1x1, BN, ReLU, 3x3, BN, ReLU, 1x1.
The lifter is 3d-pose-baseline's: ``encode`` (Linear, BN), two blocks of
two (Linear, BN), ``decode`` (Linear).
"""
from __future__ import annotations

from typing import Iterator, Tuple

Leaf = Tuple[tuple, str, tuple]


def res_module(path: tuple, ci: int, co: int) -> Iterator[Leaf]:
    half = co // 2
    if ci != co:
        yield path + ("conv_skip",), "conv", (1, 1, ci, co)
    yield path + ("bn1",), "bn", (ci,)
    yield path + ("conv1",), "conv", (1, 1, ci, half)
    yield path + ("bn2",), "bn", (half,)
    yield path + ("conv2",), "conv", (3, 3, half, half)
    yield path + ("bn3",), "bn", (half,)
    yield path + ("conv3",), "conv", (1, 1, half, co)


def hourglass(path: tuple, depth: int, f: int) -> Iterator[Leaf]:
    for slot in ("res1", "res2", "res3"):
        yield from res_module(path + (slot,), f, f)
    if depth > 1:
        yield from hourglass(path + ("sub",), depth - 1, f)
    else:
        yield from res_module(path + ("waist",), f, f)


def detector_leaves(cfg: dict) -> Iterator[Leaf]:
    """The torch7 detector's leaves (under the End2End tree's
    ``hourglass``)."""
    s, f, j = cfg["nStack"], cfg["nFeats"], cfg["nParts"]
    c0, c1 = cfg["stem_channels"], cfg["stem_res_channels"]
    yield ("stem_conv",), "conv", (7, 7, 3, c0)
    yield ("stem_bn",), "bn", (c0,)
    yield from res_module(("stem_res1",), c0, c1)
    yield from res_module(("stem_res2",), c1, c1)
    yield from res_module(("stem_res3",), c1, f)
    for i in range(s):
        yield from hourglass((f"hg_{i}",), cfg["depth"], f)
    for i in range(s):
        yield (f"lin_{i}", "conv"), "conv", (1, 1, f, f)
        yield (f"lin_{i}", "bn"), "bn", (f,)
    for i in range(s):
        yield (f"htmap_{i}",), "conv", (1, 1, f, j)
    for i in range(s - 1):
        yield (f"ll_bar_{i}",), "conv", (1, 1, f, f)
    for i in range(s - 1):
        yield (f"htmap_bar_{i}",), "conv", (1, 1, j, f)


def lifter_leaves(cfg: dict) -> Iterator[Leaf]:
    """The lifter's leaves (the lifting tree, or End2End's ``bilinear``)."""
    d_in, h, d_out = cfg["input_size"], cfg["linear_size"], cfg["output_size"]
    yield ("encode", "linear"), "dense", (d_in, h)
    yield ("encode", "bn"), "bn", (h,)
    for b in range(cfg["num_layers"]):
        for s in range(2):
            yield (f"bilinear_{b}_{s}", "linear"), "dense", (h, h)
            yield (f"bilinear_{b}_{s}", "bn"), "bn", (h,)
    yield ("decode",), "dense", (h, d_out)


def model_leaves(cfg: dict) -> Iterator[Leaf]:
    """Every leaf of a configuration, End2End's under ``hourglass`` and
    ``bilinear`` as its tree holds them."""
    if cfg["model"] == "lifter":
        yield from lifter_leaves(cfg)
        return
    for path, kind, shape in detector_leaves(cfg):
        yield ("hourglass",) + path, kind, shape
    for path, kind, shape in lifter_leaves(cfg["lifter"]):
        yield ("bilinear",) + path, kind, shape
