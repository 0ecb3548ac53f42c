"""HRNet-W48, the pose detector of Sun, Xiao, Liu, Wang: Deep High-Resolution
Representation Learning for Human Pose Estimation (CVPR 2019), as
``lib/models/pose_hrnet.py`` of deep-high-resolution-net.pytorch builds it
for ``experiments/mpii/hrnet/w48_256x256_adam_lr1e-3.yaml``, with its
state_dict names (``conv1``, ``bn1``, ``conv2``, ``bn2``, ``layer1.{k}``,
``transition{1,2,3}.{i}``, ``stage{2,3,4}.{m}.branches.{i}.{k}``,
``stage{s}.{m}.fuse_layers.{i}.{j}``, ``final_layer``), so a published
checkpoint maps onto it by name.

- Stem: 3x3/s2 conv 3->64, BN, ReLU, 3x3/s2 conv 64->64, BN, ReLU; then
  ``layer1``, four Bottlenecks (1x1 64, 3x3 64, 1x1 256, the first with a
  1x1 + BN downsample).
- ``transition{s}`` adds branch s by a 3x3/s2 conv + BN + ReLU from the last
  branch (transition1 also maps the 256 channels to the first branch's 48).
- ``stage2``, ``stage3``, ``stage4``: 1, 4 and 3 multi-branch modules over
  2, 3 and 4 branches of widths 48 / 96 / 192 / 384 at 1/4 ... 1/32 of the
  frame. A module runs 4 BasicBlocks per branch, then its exchange: output i
  is the ReLU of the sum over inputs j of the identity (j = i), a 1x1 conv
  + BN + nearest upsample x2^(j-i) (j > i), or i-j strided 3x3 convs (j <
  i; each + BN + ReLU but the last, which has no ReLU). The last module
  gives branch 0 only.
- ``final_layer``: a 1x1 conv 48 -> 16 with a bias, the 64x64 heatmaps.

Every other conv is bias-free, as published. ``forward`` takes (B, H, W,
3) images and returns (1, B, H/4, W/4, J) f32 heatmaps: the detectors'
layout, with one stage where the hourglasses have one per stack. Precision
is the hourglasses' (``hourglass_torch7.conv_in`` / ``bn_in``): parameters
in f32, convs in ``dtype``, each BN (``core.norm.BatchNorm2d``) in f32 on
the rounded conv output and rounded back; the adds, ReLUs and upsamples
in ``dtype``. Activations are NCHW tensors in ``torch.channels_last``.

The model runs on cuDNN's convolutions and torch's ops: it has no fused
kernel path, no int8 path and no spatially sharded forward, and it is
served, not trained, by the port (``train/hourglass.py::make_model``
refuses the rest).

Spans (``utils/profiling.py::span``), ``SPANS``: ``hrnet.stem`` (the stem
and ``layer1``), ``hrnet.transition`` (each transition), ``hrnet.branches``
(a module's BasicBlock chains), ``hrnet.exchange`` (a module's exchange)
and ``hrnet.head`` (``final_layer``): 21 a forward.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from bilinear_tpu_torch.core.norm import BatchNorm2d
from bilinear_tpu_torch.models.hourglass_torch7 import CL, bn_in, conv_in
from bilinear_tpu_torch.utils.profiling import span

WIDTH = 48
N_JOINTS = 16
STEM_CHANNELS = 64
# (modules, branches, BasicBlocks a branch) of stages 2, 3 and 4 (the
# yaml's STAGE2-4; every branch of a module has the same block count).
STAGES = ((1, 2, 4), (4, 3, 4), (3, 4, 4))
LAYER1_BLOCKS = 4
BN_MOMENTUM = 0.1
SPANS = ("hrnet.stem", "hrnet.transition", "hrnet.branches",
         "hrnet.exchange", "hrnet.head")


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def _conv1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, bias=False)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, momentum=BN_MOMENTUM)


def _conv_bn(conv: nn.Conv2d, bn: BatchNorm2d, x: torch.Tensor, dtype
             ) -> torch.Tensor:
    return bn_in(bn, conv_in(conv, x, dtype), dtype)


def _seq(seq: nn.Sequential, x: torch.Tensor, dtype) -> torch.Tensor:
    """A published (conv, BN[, ReLU[, Upsample]]) Sequential in ``dtype``."""
    y = _conv_bn(seq[0], seq[1], x, dtype)
    for m in seq[2:]:
        y = torch.relu(y) if isinstance(m, nn.ReLU) else m(y)
    return y


class Bottleneck(nn.Module):
    """``layer1``'s block: 1x1, 3x3, 1x1 x4, each conv then BN; ReLU after
    the first two and after the residual sum."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, dtype=torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.dtype = dtype
        self.conv1, self.bn1 = _conv1(inplanes, planes), _bn(planes)
        self.conv2, self.bn2 = _conv3(planes, planes), _bn(planes)
        self.conv3, self.bn3 = _conv1(planes, out), _bn(out)
        self.downsample = None if inplanes == out else nn.Sequential(
            _conv1(inplanes, out), _bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = torch.relu(_conv_bn(self.conv1, self.bn1, x, dt))
        h = torch.relu(_conv_bn(self.conv2, self.bn2, h, dt))
        h = _conv_bn(self.conv3, self.bn3, h, dt)
        skip = x if self.downsample is None else _seq(self.downsample, x, dt)
        return torch.relu(h + skip)


class BasicBlock(nn.Module):
    """A branch's block: 3x3, BN, ReLU, 3x3, BN, + identity, ReLU."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1, self.bn1 = _conv3(channels, channels), _bn(channels)
        self.conv2, self.bn2 = _conv3(channels, channels), _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = torch.relu(_conv_bn(self.conv1, self.bn1, x, dt))
        return torch.relu(_conv_bn(self.conv2, self.bn2, h, dt) + x)


class HighResolutionModule(nn.Module):
    """One multi-branch module: ``branches.{i}`` (BasicBlock chains), then
    the exchange ``fuse_layers.{i}.{j}`` (None for j = i)."""

    def __init__(self, channels: Sequence[int], blocks: int,
                 multi_scale_output: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(c, dtype) for _ in range(blocks)))
            for c in channels)
        self.fuse_layers = None if n == 1 else nn.ModuleList(
            nn.ModuleList(self._fuse(channels, i, j) for j in range(n))
            for i in range(n if multi_scale_output else 1))

    @staticmethod
    def _fuse(channels: Sequence[int], i: int, j: int):
        ci, cj = channels[i], channels[j]
        if j > i:
            return nn.Sequential(_conv1(cj, ci), _bn(ci), nn.Upsample(
                scale_factor=2 ** (j - i), mode="nearest"))
        if j == i:
            return None
        steps = []
        for k in range(i - j):
            if k == i - j - 1:
                steps.append(nn.Sequential(_conv3(cj, ci, 2), _bn(ci)))
            else:
                steps.append(nn.Sequential(_conv3(cj, cj, 2), _bn(cj),
                                           nn.ReLU()))
        return nn.Sequential(*steps)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        with span("hrnet.branches"):
            xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        with span("hrnet.exchange"):
            out = []
            for i, row in enumerate(self.fuse_layers):
                y = None
                for j, x in enumerate(xs):
                    t = x if j == i else _chain(row[j], x, self.dtype)
                    y = t if y is None else y + t
                out.append(torch.relu(y))
        return out


class PoseHighResolutionNet(nn.Module):
    """The whole detector. ``width`` is the first branch's (48 for W48); the
    others double it."""

    variant = "hrnet"

    def __init__(self, width: int = WIDTH, n_joints: int = N_JOINTS,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.width = width
        c0 = STEM_CHANNELS
        self.conv1, self.bn1 = _conv3(3, c0, 2), _bn(c0)
        self.conv2, self.bn2 = _conv3(c0, c0, 2), _bn(c0)
        self.layer1 = nn.Sequential(*(
            Bottleneck(c0 if k == 0 else c0 * Bottleneck.expansion, c0,
                       dtype) for k in range(LAYER1_BLOCKS)))
        pre = [c0 * Bottleneck.expansion]
        for s, (modules, branches, blocks) in enumerate(STAGES, start=2):
            cur = [width * 2 ** b for b in range(branches)]
            setattr(self, f"transition{s - 1}", _transition(pre, cur))
            last = s == len(STAGES) + 1
            setattr(self, f"stage{s}", nn.Sequential(*(
                HighResolutionModule(cur, blocks, not (
                    last and m == modules - 1), dtype)
                for m in range(modules))))
            pre = cur
        self.final_layer = nn.Conv2d(width, n_joints, 1)
        init_weights(self, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = images.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=CL)
        with span("hrnet.stem"):
            x = torch.relu(_conv_bn(self.conv1, self.bn1, x, dt))
            x = torch.relu(_conv_bn(self.conv2, self.bn2, x, dt))
            xs = [self.layer1(x)]
        for s in range(2, len(STAGES) + 2):
            with span("hrnet.transition"):
                xs = [xs[i] if t is None else _chain(t, xs[-1], dt)
                      for i, t in enumerate(getattr(self,
                                                    f"transition{s - 1}"))]
            xs = getattr(self, f"stage{s}")(xs)
        with span("hrnet.head"):
            heat = conv_in(self.final_layer, xs[0], dt)
            out = heat.to(torch.promote_types(torch.float32, dt))
            return out.permute(0, 2, 3, 1).unsqueeze(0)


def _transition(pre: Sequence[int], cur: Sequence[int]) -> nn.ModuleList:
    """pose_hrnet.py's ``_make_transition_layer``: None where a branch keeps
    its channels, a 3x3 conv + BN + ReLU where they change, and for a new
    branch a chain of 3x3/s2 convs from the last branch, the last one
    giving the new width."""
    layers = []
    for i, c in enumerate(cur):
        if i < len(pre):
            layers.append(None if c == pre[i] else nn.Sequential(
                _conv3(pre[i], c), _bn(c), nn.ReLU()))
            continue
        steps = []
        for k in range(i + 1 - len(pre)):
            cin = pre[-1]
            cout = c if k == i - len(pre) else cin
            steps.append(nn.Sequential(_conv3(cin, cout, 2), _bn(cout),
                                       nn.ReLU()))
        layers.append(nn.Sequential(*steps))
    return nn.ModuleList(layers)


def _chain(layer: nn.Sequential, x: torch.Tensor, dtype) -> torch.Tensor:
    """A transition's or an exchange's entry: one (conv, BN, ...) Sequential,
    or a chain of them."""
    if isinstance(layer[0], nn.Conv2d):
        return _seq(layer, x, dtype)
    for step in layer:
        x = _seq(step, x, dtype)
    return x


@torch.no_grad()
def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """pose_hrnet.py's ``init_weights`` without a checkpoint: conv weights
    N(0, 0.001^2) drawn from ``generator``, conv biases 0, BN at gamma 1,
    beta 0."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, 0.001, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
