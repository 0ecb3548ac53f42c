"""Stacked hourglass, the pre-activation variant (counterpart of
``bilinear_tpu/models/hourglass.py``; the reference's StackedHourglass,
model/hourglass.py:92-151), the network the H36M fine-tuning trains, with
the reference's state_dict names (``feature_extraction.*``,
``hourglass.{i}.{skip_connection.t, downscale.t.1, res, upscale.t.0}``,
``prev_heatmap.{i}.{0,1}``, ``heatmap_intermediate.{i}``,
``after_heatmap.{i}``, ``skip_intermediate.{i}``).

- ``LightConv``: BN -> ReLU -> conv, bias-less except the heatmap heads';
  a ``ResUnit`` is three of them (1x1, 3x3, 1x1 at half width) plus the
  identity, or a biased 1x1 ``skip`` conv where the channel count changes.
- The stem's 7x7 conv has no BN or ReLU after it (the reference comments
  them out).
- Per stack: hourglass -> ``prev_heatmap`` (ResUnit + 1x1 LightConv) ->
  ``skip_intermediate`` and the heatmap head; the next stack's input is
  ``after_heatmap(heatmap) + skip + the stack's input``.
- Every BN is cumulative (``momentum=None``) from the first step, through
  ``core.norm.BatchNorm2d``, which never reads the card on the host.

``n_modules`` chains that many ResUnits per hourglass slot (the JAX
package's knob; the reference has one). The first keeps the reference's
name; module k > 0 of a slot is ``skip_connection_m{k}.{t}``,
``downscale_m{k}.{t}``, ``res_m{k}`` or ``upscale_m{k}.{t}``, as the JAX
tree's ``{slot}_m{k}``.

``forward`` takes (B, H, W, 3) images and returns (S, B, H/4, W/4, J)
heatmaps in f32; inside, activations are NCHW tensors in
``torch.channels_last``. Precision as in JAX: parameters are f32; convs run
in ``dtype`` (``core/precision.py``), each BN runs in f32 on its input in
``BatchNorm2d``'s own formulation, on the card too, and is rounded back to
``dtype``. The fused ResModule kernels are the torch7 variant's.

``quantize="int8"`` runs, in eval mode, the three LightConvs of every
ResUnit (the stem's, the hourglasses' and each ``prev_heatmap``'s) as
dynamic int8 convolutions (``ops/int8.py``: kernels K6/K7 on a CUDA
tensor), as JAX's ``StackedHourglass`` does; the stem conv, the ResUnits'
skip convs and the stack heads (``prev_heatmap``'s 1x1, the skip, heatmap
and after-heatmap LightConvs) stay float. Train mode ignores it and the
state_dict is the same.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bilinear_tpu_torch.core import remat
from bilinear_tpu_torch.core.norm import BatchNorm2d
from bilinear_tpu_torch.core.precision import CL, conv_in, wide
from bilinear_tpu_torch.ops import int8

N_STACKS = 8
N_FEATURES = 256
N_JOINTS = 16
N_DEPTH = 4


class LightConv(nn.Sequential):
    """model/hourglass.py:7-12: [BN, ReLU, Conv]; with ``quantize="int8"``
    the conv runs as an int8 conv in eval mode."""

    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 bias: bool = False, dtype=torch.float32,
                 quantize: Optional[str] = None):
        super().__init__(BatchNorm2d(cin), nn.ReLU(),
                         nn.Conv2d(cin, cout, kernel,
                                   padding=(kernel - 1) // 2, bias=bias))
        if quantize not in int8.MODES:
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        self.dtype = dtype
        self.quantize = quantize

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self[0](x.to(wide(self.dtype))).to(self.dtype))
        if self.quantize == "int8" and not self.training:
            return int8.conv2d(self[2], h, self.dtype)
        return conv_in(self[2], h, self.dtype)


class ResUnit(nn.Module):
    """model/hourglass.py:34-52: ``conv`` (three LightConvs) + ``skip``."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32,
                 quantize: Optional[str] = None):
        super().__init__()
        half = cout // 2
        self.dtype = dtype
        kw = dict(dtype=dtype, quantize=quantize)
        self.conv = nn.Sequential(LightConv(cin, half, 1, **kw),
                                  LightConv(half, half, 3, **kw),
                                  LightConv(half, cout, 1, **kw))
        self.skip = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x.to(self.dtype) if self.skip is None else \
            conv_in(self.skip, x, self.dtype)
        return self.conv(x) + skip


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _upsample(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Hourglass(nn.Module):
    """model/hourglass.py:55-89: ``depth`` levels of [skip branch, max pool
    + ResUnit down], the waist, then [ResUnit up, nearest x2, + skip]."""

    def __init__(self, channels: int, depth: int = N_DEPTH,
                 dtype=torch.float32, n_modules: int = 1,
                 quantize: Optional[str] = None):
        super().__init__()
        self.depth, self.n_modules = depth, n_modules

        def unit():
            return ResUnit(channels, channels, dtype, quantize)

        def units():
            return nn.ModuleList(unit() for _ in range(depth))

        self.skip_connection = units()
        self.downscale = nn.ModuleList(
            nn.Sequential(nn.MaxPool2d(2, 2), unit()) for _ in range(depth))
        self.res = unit()
        self.upscale = nn.ModuleList(
            nn.Sequential(unit(), nn.Upsample(scale_factor=2,
                                              mode="nearest"))
            for _ in range(depth))
        for k in range(1, n_modules):
            setattr(self, f"skip_connection_m{k}", units())
            setattr(self, f"downscale_m{k}", units())
            setattr(self, f"res_m{k}", unit())
            setattr(self, f"upscale_m{k}", units())

    def _chain(self, slot: str, t: Optional[int], first: nn.Module,
               h: torch.Tensor) -> torch.Tensor:
        h = first(h)
        for k in range(1, self.n_modules):
            extra = getattr(self, f"{slot}_m{k}")
            h = (extra if t is None else extra[t])(h)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        h = x
        for t in range(self.depth):
            skips.append(self._chain("skip_connection", t,
                                     self.skip_connection[t], h))
            h = self._chain("downscale", t, self.downscale[t][1], _pool(h))
        h = self._chain("res", None, self.res, h)
        for t, skip in zip(range(self.depth), reversed(skips)):
            h = self._chain("upscale", t, self.upscale[t][0], h)
            h = _upsample(h) + skip
        return h


class StackedHourglass(nn.Module):
    """The full detector (model/hourglass.py:92-151)."""

    variant = "preact"
    fused_blocks = False  # the K3/K4 blocks are the torch7 ResModule's
    int8_convs = True
    trainable = True
    spatial_sharding = True
    eval_plan = False
    input_size = (256, 256)
    heatmap_size = (64, 64)
    size_args = {k: k for k in ("n_stacks", "features", "depth",
                                "n_modules")}

    def __init__(self, n_stacks: int = N_STACKS, features: int = N_FEATURES,
                 n_joints: int = N_JOINTS, depth: int = N_DEPTH,
                 dtype=torch.float32, n_modules: int = 1,
                 quantize: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if quantize not in int8.MODES:
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        self.n_stacks, self.dtype = n_stacks, dtype
        # Train-mode forwards under autograd recompute the stem's and each
        # stack's activations in the backward (core/remat.py).
        self.remat = False
        q = quantize
        self.feature_extraction = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            ResUnit(64, 128, dtype, q), nn.MaxPool2d(2, 2),
            ResUnit(128, 128, dtype, q), ResUnit(128, features, dtype, q))
        self.hourglass = nn.ModuleList(
            Hourglass(features, depth, dtype, n_modules, q)
            for _ in range(n_stacks))
        self.prev_heatmap = nn.ModuleList(
            nn.Sequential(ResUnit(features, features, dtype, q),
                          LightConv(features, features, dtype=dtype))
            for _ in range(n_stacks))
        self.heatmap_intermediate = nn.ModuleList(
            LightConv(features, n_joints, bias=True, dtype=dtype)
            for _ in range(n_stacks))
        self.after_heatmap = nn.ModuleList(
            LightConv(n_joints, features, dtype=dtype)
            for _ in range(n_stacks))
        self.skip_intermediate = nn.ModuleList(
            LightConv(features, features, dtype=dtype)
            for _ in range(n_stacks))
        init_weights(self, generator)

    def stem(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = images.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=CL)
        fe = self.feature_extraction
        h = conv_in(fe[0], x, dt)
        return fe[4](fe[3](_pool(fe[1](h))))

    def stack(self, i: int, h: torch.Tensor):
        """Stack ``i``: (its heatmaps (B, H/4, W/4, J), the next input)."""
        prev = h
        h = self.prev_heatmap[i](self.hourglass[i](h))
        skip = self.skip_intermediate[i](h)
        pred = self.heatmap_intermediate[i](h)
        h = self.after_heatmap[i](pred) + skip + prev
        return pred.to(wide(self.dtype)).permute(0, 2, 3, 1), h

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        call = remat.runner(self)
        h = call(self.stem, images)
        heatmaps = []
        for i in range(self.n_stacks):
            out, h = call(self.stack, i, h)
            heatmaps.append(out)
        return torch.stack(heatmaps, dim=0)  # (S, B, H/4, W/4, J)


@torch.no_grad()
def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """torch's default Conv2d init (kaiming-uniform a=sqrt(5), bias
    U(+-1/sqrt(fan_in))) drawn from ``generator``; BN at gamma 1, beta 0."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            if m.bias is not None:
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.bias.uniform_(-bound, bound, generator=generator)
