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
is the hourglasses' (``core/precision.py::conv_in`` / ``bn_in``): parameters
in f32, convs in ``dtype``, each BN (``core.norm.BatchNorm2d``) in f32 on
the rounded conv output and rounded back; the adds, ReLUs and upsamples
in ``dtype``. Activations are NCHW tensors in ``torch.channels_last``.

Eval plan. ``build_eval_plan`` (``End2EndServer`` calls it on each model
it builds, after ``.eval()`` and the move to its device) casts every conv
weight to ``dtype`` in channels_last once (``conv_in`` casts it at each
call, and cuDNN then copies each 3x3 into the activations' layout) and
turns every BN into an f32 (scale, shift) table
(``ops.conv_epilogue.bn_affine``); ``train()`` drops it. An eval
forward with a plan runs each conv on its prepared weight and everything
after it up to the next conv (the BN, a residual or exchange sum of up to
four terms with their own BNs and nearest upsamples, the ReLU; the head's
bias and its f32 output) as one ``ops.conv_epilogue.conv_epilogue`` call,
kernel K8 on the card, at the same rounding points: 262 a forward at W48.
Without a plan, or in train mode, the forward is the composition above,
op by op. The class attributes say what the port runs it with: no int8
path, no spatially sharded forward, served and not trained.

Spans (``utils/profiling.py::span``), ``SPANS``: ``hrnet.stem`` (the stem
and ``layer1``), ``hrnet.transition`` (each transition), ``hrnet.branches``
(a module's BasicBlock chains), ``hrnet.exchange`` (a module's exchange)
and ``hrnet.head`` (``final_layer``): 21 a forward.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from bilinear_tpu_torch.core.norm import BatchNorm2d
from bilinear_tpu_torch.core.precision import CL, bn_in, conv_in, wide
from bilinear_tpu_torch.ops.conv_epilogue import bn_affine, conv_epilogue
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


class EvalPlan(NamedTuple):
    """What an eval forward reads in place of the parameters: each conv's
    weight in the model's dtype and in channels_last (the activations'
    layout, which cuDNN would otherwise copy the weight into at every
    call), each BN's (2, C) (scale, shift) table, and the head's (scale 1,
    its bias rounded to the dtype)."""

    weights: Dict[nn.Conv2d, torch.Tensor]
    affines: Dict[nn.Module, torch.Tensor]


# A term of a sum: an activation, or a conv's output with the BN it has
# still to go through.
Term = Union[torch.Tensor, Tuple[torch.Tensor, BatchNorm2d]]


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def _conv1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, bias=False)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, momentum=BN_MOMENTUM)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype,
          plan: Optional[EvalPlan]) -> torch.Tensor:
    """``conv_in``, or with a plan the conv on its prepared weight (the
    head's bias is left to its epilogue)."""
    if plan is None:
        return conv_in(conv, x, dtype)
    return F.conv2d(x, plan.weights[conv], None, conv.stride, conv.padding)


def _pending(conv: nn.Conv2d, bn: BatchNorm2d, x: torch.Tensor, dtype,
             plan: Optional[EvalPlan]) -> Term:
    return _conv(conv, x, dtype, plan), bn


def _sum(terms: Sequence[Term], dtype, plan: Optional[EvalPlan],
         relu: bool = True) -> torch.Tensor:
    """The ReLU (``relu``) of the terms' sum in their order, at the first
    term's resolution: a pending term goes through its BN first and, at a
    lower resolution, is upsampled (nearest). With a plan, one
    ``conv_epilogue`` call."""
    if plan is not None:
        return conv_epilogue([(t, None) if torch.is_tensor(t) else
                              (t[0], plan.affines[t[1]]) for t in terms],
                             relu)
    y = None
    for t in terms:
        if not torch.is_tensor(t):
            t = bn_in(t[1], t[0], dtype)
        if y is not None and t.shape[-1] != y.shape[-1]:
            t = F.interpolate(t, scale_factor=y.shape[-1] // t.shape[-1],
                              mode="nearest")
        y = t if y is None else y + t
    return torch.relu(y) if relu else y


def _chain(layer: nn.Sequential, x: torch.Tensor, dtype,
           plan: Optional[EvalPlan]) -> Term:
    """A transition's, an exchange's or a downsample's entry: one (conv,
    BN[, ReLU]) Sequential or a chain of them. A step with a ReLU is
    applied; the last step's BN, where it has none, is left pending."""
    steps = [layer] if isinstance(layer[0], nn.Conv2d) else list(layer)
    for step in steps:
        x = _pending(step[0], step[1], x, dtype, plan)
        if isinstance(step[-1], nn.ReLU):
            x = _sum([x], dtype, plan)
    return x


def _run(seq: nn.Sequential, x, plan: Optional[EvalPlan]):
    for module in seq:
        x = module(x, plan)
    return x


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

    def forward(self, x: torch.Tensor,
                plan: Optional[EvalPlan] = None) -> torch.Tensor:
        dt = self.dtype
        h = _sum([_pending(self.conv1, self.bn1, x, dt, plan)], dt, plan)
        h = _sum([_pending(self.conv2, self.bn2, h, dt, plan)], dt, plan)
        h = _pending(self.conv3, self.bn3, h, dt, plan)
        skip = x if self.downsample is None else _chain(self.downsample, x,
                                                        dt, plan)
        return _sum([h, skip], dt, plan)


class BasicBlock(nn.Module):
    """A branch's block: 3x3, BN, ReLU, 3x3, BN, + identity, ReLU."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1, self.bn1 = _conv3(channels, channels), _bn(channels)
        self.conv2, self.bn2 = _conv3(channels, channels), _bn(channels)

    def forward(self, x: torch.Tensor,
                plan: Optional[EvalPlan] = None) -> torch.Tensor:
        dt = self.dtype
        h = _sum([_pending(self.conv1, self.bn1, x, dt, plan)], dt, plan)
        return _sum([_pending(self.conv2, self.bn2, h, dt, plan), x], dt,
                    plan)


class HighResolutionModule(nn.Module):
    """One multi-branch module: ``branches.{i}`` (BasicBlock chains), then
    the exchange ``fuse_layers.{i}.{j}`` (None for j = i; for j > i the
    1x1 conv and its BN, upsampled by the sum)."""

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
            return nn.Sequential(_conv1(cj, ci), _bn(ci))
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

    def forward(self, xs: List[torch.Tensor],
                plan: Optional[EvalPlan] = None) -> List[torch.Tensor]:
        dt = self.dtype
        with span("hrnet.branches"):
            xs = [_run(branch, x, plan)
                  for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        with span("hrnet.exchange"):
            return [_sum([x if j == i else _chain(row[j], x, dt, plan)
                          for j, x in enumerate(xs)], dt, plan)
                    for i, row in enumerate(self.fuse_layers)]


class PoseHighResolutionNet(nn.Module):
    """The whole detector. ``width`` is the first branch's (48 for W48); the
    others double it."""

    # No spatial sharding: its exchange units join every resolution.
    variant = "hrnet"
    fused_blocks = False
    int8_convs = False
    trainable = False
    spatial_sharding = False
    eval_plan = True
    input_size = (256, 256)
    heatmap_size = (64, 64)
    size_args = {"features": "width"}  # sized by its width alone

    def __init__(self, width: int = WIDTH, n_joints: int = N_JOINTS,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.width = width
        self.plan: Optional[EvalPlan] = None
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

    @torch.no_grad()
    def build_eval_plan(self) -> "PoseHighResolutionNet":
        """Prepare the eval plan from the parameters and running statistics
        as they are now, on their device: build it after loading and
        moving the model. Returns the model."""
        dt = self.dtype
        at = wide(dt)
        weights, affines = {}, {}
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                weights[m] = m.weight.to(dt).contiguous(memory_format=CL)
            elif isinstance(m, nn.BatchNorm2d):
                affines[m] = bn_affine(m, at)
        bias = self.final_layer.bias.to(dt).to(at)
        affines[self.final_layer] = torch.stack([torch.ones_like(bias),
                                                 bias])
        self.plan = EvalPlan(weights, affines)
        return self

    def train(self, mode: bool = True) -> "PoseHighResolutionNet":
        if mode:
            self.plan = None
        return super().train(mode)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        plan = None if self.training else self.plan
        x = images.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=CL)
        with span("hrnet.stem"):
            x = _sum([_pending(self.conv1, self.bn1, x, dt, plan)], dt, plan)
            x = _sum([_pending(self.conv2, self.bn2, x, dt, plan)], dt, plan)
            xs = [_run(self.layer1, x, plan)]
        for s in range(2, len(STAGES) + 2):
            with span("hrnet.transition"):
                xs = [xs[i] if t is None else _chain(t, xs[-1], dt, plan)
                      for i, t in enumerate(getattr(self,
                                                    f"transition{s - 1}"))]
            xs = _run(getattr(self, f"stage{s}"), xs, plan)
        with span("hrnet.head"):
            out_dt = wide(dt)
            heat = _conv(self.final_layer, xs[0], dt, plan)
            if plan is None:
                out = heat.to(out_dt)
            else:
                out = conv_epilogue(
                    [(heat, plan.affines[self.final_layer])],
                    out_dtype=out_dt)
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
