"""The leaves of End2End with a ViTPose detector, in the ``.save`` tree the
port's ``End2EndServer(variant="vitpose")`` takes: the detector under
``hourglass`` with the published module names, one tree level per dotted
component (``backbone.blocks.3.attn.qkv`` is the path ``("backbone",
"blocks", "3", "attn", "qkv")``), and the lifter under ``bilinear`` as
``layout.py`` lays it out.

A leaf is ``(path, kind, shape)`` as in ``layout.py``, with more kinds:

- ``conv_b``: ``kernel`` (kh, kw, in, out) and ``bias`` (out,)
  (``patch_embed.proj``, ``final_layer``);
- ``dense``: ``kernel`` (in, out) and ``bias`` (out,) (every Linear);
- ``ln``: ``scale`` and ``bias`` (C,), a LayerNorm (no statistics);
- ``pos``: ``value`` (1, 1 + tokens, C), ``pos_embed``;
- ``deconv``: ``kernel`` (kh, kw, in, out), a bias-free ConvTranspose2d
  (whose torch weight is (in, out, kh, kw));
- ``bn``: as in ``layout.py``.

The network (``mmpose/models/backbones/vit.py`` and
``TopdownHeatmapSimpleHead`` of ViTAE-Transformer/ViTPose, configured by
``ViTPose_huge_mpii_256x192.py``): the patch embedding, a conv of the
patch size with stride ``patch_size // ratio`` and padding ``4 + 2 *
(ratio // 2 - 1)``; ``pos_embed`` over one more token than the patches;
``depth`` pre-norm blocks (``norm1``, ``attn.qkv``, ``attn.proj``,
``norm2``, ``mlp.fc1``, ``mlp.fc2``); ``last_norm``; then the head's
deconvolutions (``deconv_layers.{0, 3}``, each with its BN ``{1, 4}`` and
a ReLU ``{2, 5}``) and ``final_layer``.
"""
from __future__ import annotations

from typing import Iterator, Tuple

from portbench.reference import layout


def grid(cfg: dict) -> Tuple[int, int]:
    """(rows, columns) of patch tokens: the patch embedding's output on the
    configuration's ``img_size`` (H, W)."""
    b = cfg["backbone"]
    k, s = b["patch_size"], b["patch_size"] // b["ratio"]
    pad = 4 + 2 * (b["ratio"] // 2 - 1)
    return tuple((n + 2 * pad - k) // s + 1 for n in b["img_size"])


def padding(cfg: dict) -> int:
    return 4 + 2 * (cfg["backbone"]["ratio"] // 2 - 1)


def detector_leaves(cfg: dict) -> Iterator[layout.Leaf]:
    """Every leaf of the detector in registration order."""
    b, h = cfg["backbone"], cfg["keypoint_head"]
    c, k = b["embed_dim"], b["patch_size"]
    rows, cols = grid(cfg)
    hidden = c * b["mlp_ratio"]
    bb = ("backbone",)
    yield bb + ("patch_embed", "proj"), "conv_b", (k, k, 3, c)
    yield bb + ("pos_embed",), "pos", (1, 1 + rows * cols, c)
    for i in range(b["depth"]):
        p = bb + ("blocks", str(i))
        yield p + ("norm1",), "ln", (c,)
        yield p + ("attn", "qkv"), "dense", (c, 3 * c)
        yield p + ("attn", "proj"), "dense", (c, c)
        yield p + ("norm2",), "ln", (c,)
        yield p + ("mlp", "fc1"), "dense", (c, hidden)
        yield p + ("mlp", "fc2"), "dense", (hidden, c)
    yield bb + ("last_norm",), "ln", (c,)
    cin = h["in_channels"]
    for n, (co, kk) in enumerate(zip(h["num_deconv_filters"],
                                     h["num_deconv_kernels"])):
        p = ("keypoint_head", "deconv_layers")
        yield p + (str(3 * n),), "deconv", (kk, kk, cin, co)
        yield p + (str(3 * n + 1),), "bn", (co,)
        cin = co
    f = h["final_conv_kernel"]
    yield ("keypoint_head", "final_layer"), "conv_b", (f, f, cin,
                                                      h["out_channels"])


def model_leaves(cfg: dict) -> Iterator[layout.Leaf]:
    """Every leaf of End2End, the detector's under ``hourglass`` and the
    lifter's under ``bilinear``."""
    for path, kind, shape in detector_leaves(cfg):
        yield ("hourglass",) + path, kind, shape
    for path, kind, shape in layout.lifter_leaves(cfg["lifter"]):
        yield ("bilinear",) + path, kind, shape
