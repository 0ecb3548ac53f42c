"""Stacked hourglass, the torch7-faithful variant (counterpart of
``bilinear_tpu/models/hourglass_torch7.py``), with the reference's
state_dict names (``beforeHourglass.*``, ``hgArray.*``, ``linArray.*``,
``htmapArray.*``, ``llBarArray.*``, ``htmapBarArray.*``).

Conv7x7/s2 -> BN -> ReLU -> Res(64->128) -> MaxPool -> Res(128,128) ->
Res(128,256), then ``n_stacks`` of [depth-``depth`` recursive hourglass ->
lin (1x1 conv + BN + ReLU) -> 1x1 heatmap conv] with the inter-stack
feedback ``inter + ll_bar(ll) + htmap_bar(htmap)``.

``forward`` takes (B, H, W, 3) images and returns (S, B, H/4, W/4, J) f32
heatmaps, the JAX package's layout. Inside, activations are NCHW tensors in
``torch.channels_last``: a (B, C, H, W) tensor is then a (B*H*W, C) row
matrix in memory, which the fused ResModule kernels read without a copy.

Precision as in JAX: parameters are f32; convs run in ``dtype`` (inputs and
weights cast, the bias rounded to ``dtype`` and added in ``dtype``), BN runs
in f32 on the conv output and is rounded back to ``dtype``; heatmaps are
returned in f32. Every BN module is ``core.norm.BatchNorm2d`` (torch's
parameters, buffers and running update). ``bn_in`` applies it through
torch's own BN on a CUDA tensor (cuDNN) and through the module's own
formulation on a CPU tensor (the statistics by ``torch.var_mean``, the
normalisation in autograd's own ops): torch's CPU BN backward loses the
per-channel sums when the upstream gradient has a large mean, as End2End's
soft-argmax gives it, where cuDNN's keeps them. In the fused ResModules the
BNs hold parameters and buffers only.

``fused=True`` runs every ResModule through kernels K3/K4
(``ops/resmodule.py``) on a CUDA tensor, and through their plain versions
on a CPU tensor. Unlike the TPU path there is no memory gate: the 128x128
stem block runs the kernels too. ``conv_skip`` is always allocated, as in
the reference, and applied only when the channel count changes; the
identity blocks' copy is initialised to zeros and never trained.

``quantize="int8"`` runs the three body convs of every ResModule in eval
mode as dynamic int8 convolutions (``ops/int8.py``: kernels K6/K7 on a
CUDA tensor), as JAX's ``ResModule`` does; the skip conv, the stem and the
heads stay float. Like JAX, an int8 eval forward bypasses the fused blocks
(no K3). Train mode ignores ``quantize``, and the state_dict is the same.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bilinear_tpu_torch.core import remat
from bilinear_tpu_torch.core.norm import BatchNorm2d, active_shard, \
    update_running_stats
from bilinear_tpu_torch.ops import int8
from bilinear_tpu_torch.ops import resmodule as rk

N_STACKS = 8
N_FEATURES = 256
N_JOINTS = 16
N_DEPTH = 4

CL = torch.channels_last


def _conv(cin, cout, kernel, stride=1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride,
                     padding=(kernel - 1) // 2, bias=True)


def conv_in(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """The conv in ``dtype``: round(conv(x, W)) + round(b), in ``dtype``."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                 conv.padding)
    return y + conv.bias.to(dtype).view(1, -1, 1, 1)


def bn_in(bn: BatchNorm2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """BN in f32 (f64 for a model in f64) on the ``dtype`` activation,
    rounded back to ``dtype``: torch's own on the card, ``bn``'s own
    formulation on the CPU and under a data group of more than one rank
    (the global batch's statistics)."""
    x = x.to(torch.promote_types(torch.float32, dtype))
    own = not x.is_cuda or (bn.training and active_shard(bn) is not None)
    if own:
        return bn(x).to(dtype)
    if not (bn.training and remat.recomputing()):
        return nn.BatchNorm2d.forward(bn, x).to(dtype)
    # A recomputation (core/remat.py): torch's BN updates its buffers
    # itself, so they are put back.
    kept = [t.clone() for t in bn.buffers()]
    y = nn.BatchNorm2d.forward(bn, x)
    with torch.no_grad():
        for t, v in zip(bn.buffers(), kept):
            t.copy_(v)
    return y.to(dtype)


class ResModule(nn.Module):
    """model/hourglass_torch7.py:14-39 of the reference: conv_skip +
    resSeq = [BN, ReLU, Conv1x1, BN, ReLU, Conv3x3, BN, ReLU, Conv1x1]."""

    def __init__(self, in_channels: int, out_channels: int,
                 momentum: Optional[float] = 0.1, dtype=torch.float32,
                 fused: bool = False, quantize: Optional[str] = None):
        super().__init__()
        if quantize not in int8.MODES:
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        half = out_channels // 2
        self.in_channels, self.out_channels = in_channels, out_channels
        self.dtype = dtype
        self.fused = fused
        self.quantize = quantize
        self.conv_skip = _conv(in_channels, out_channels, 1)
        self.resSeq = nn.Sequential(
            BatchNorm2d(in_channels, momentum=momentum), nn.ReLU(),
            _conv(in_channels, half, 1),
            BatchNorm2d(half, momentum=momentum), nn.ReLU(),
            _conv(half, half, 3),
            BatchNorm2d(half, momentum=momentum), nn.ReLU(),
            _conv(half, out_channels, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=CL)
        use_int8 = self.quantize == "int8" and not self.training
        if self.fused and not use_int8:
            return self._fused(x)
        dt = self.dtype
        s = self.resSeq
        body = int8.conv2d if use_int8 else conv_in
        skip = conv_in(self.conv_skip, x, dt) \
            if self.in_channels != self.out_channels else x.to(dt)
        h = body(s[2], torch.relu(bn_in(s[0], x, dt)), dt)
        h = body(s[5], torch.relu(bn_in(s[3], h, dt)), dt)
        h = body(s[8], torch.relu(bn_in(s[6], h, dt)), dt)
        return skip + h

    def res_params(self) -> rk.ResParams:
        """The kernels' operands as differentiable views of the
        parameters: 1x1 kernels (in, out), the 3x3 kernel (9, in, out)."""
        s = tuple(self.resSeq)  # one walk; indexing a Sequential is slow
        ci, co = self.in_channels, self.out_channels
        half = co // 2
        skip = ci != co
        return rk.ResParams(
            w1=s[2].weight.view(half, ci).t(), b1=s[2].bias,
            w2=s[5].weight.permute(2, 3, 1, 0).reshape(9, half, half),
            b2=s[5].bias,
            w3=s[8].weight.view(co, half).t(), b3=s[8].bias,
            g1=s[0].weight, be1=s[0].bias, g2=s[3].weight, be2=s[3].bias,
            g3=s[6].weight, be3=s[6].bias,
            skip_w=self.conv_skip.weight.view(co, ci).t() if skip else None,
            skip_b=self.conv_skip.bias if skip else None,
        )

    def _fused(self, x: torch.Tensor) -> torch.Tensor:
        """The block through K3/K4. In training the three BNs' running
        statistics are updated in place inside ``res_block_train`` (by the
        kernels on the card); only the cumulative average
        (``momentum=None``) is updated here. Under a data group of more
        than one rank (the BNs' ``DataShard``) the block's BN reductions
        span the group (``ops/resmodule.py``: the staged K3/K4); a
        recomputation (``core/remat.py``) updates no running statistic."""
        s = tuple(self.resSeq)
        bns = (s[0], s[3], s[6])
        p = self.res_params()
        rows = x.permute(0, 2, 3, 1)  # NHWC view of channels_last memory
        if self.training:
            shard = active_shard(bns[0])
            exchange = None if shard is None else \
                rk.group_exchange(shard.group, shard.total)
            momentum = bns[0].momentum
            running = None if momentum is None or remat.recomputing() \
                else rk.RunningStats(
                    tuple(bn.running_mean for bn in bns),
                    tuple(bn.running_var for bn in bns),
                    tuple(bn.num_batches_tracked for bn in bns), momentum)
            out, st = rk.res_block_train(rows, p, dtype=self.dtype,
                                         running=running, exchange=exchange)
            if momentum is None:
                n = (rows.shape[0] if shard is None else shard.total) \
                    * rows.shape[1] * rows.shape[2]
                for bn, (m, v) in zip(bns, ((st.m1, st.v1), (st.m2, st.v2),
                                            (st.m3, st.v3))):
                    update_running_stats(bn, m, v, n)
        else:
            stats = rk.BatchStats(*(t for bn in bns for t in
                                    (bn.running_mean, bn.running_var)))
            out = rk.res_block_eval(rows, p, stats, dtype=self.dtype)
        return out.permute(0, 3, 1, 2)


def _chain(n_modules, features, **kw) -> nn.Sequential:
    return nn.Sequential(*(ResModule(features, features, **kw)
                           for _ in range(n_modules)))


class Hourglass(nn.Module):
    """Recursive encoder/decoder (reference model/hourglass_torch7.py:42-75).
    ``n_modules`` ResModules per slot, as torch's ``{slot}.{k}``."""

    def __init__(self, depth: int, features: int = N_FEATURES,
                 momentum: Optional[float] = 0.1, dtype=torch.float32,
                 fused: bool = False, quantize: Optional[str] = None,
                 n_modules: int = 1):
        super().__init__()
        kw = dict(momentum=momentum, dtype=dtype, fused=fused,
                  quantize=quantize)
        self.depth = depth
        self.res1 = _chain(n_modules, features, **kw)
        self.res2 = _chain(n_modules, features, **kw)
        self.res3 = _chain(n_modules, features, **kw)
        if depth > 1:
            self.subHourglass = Hourglass(depth - 1, features,
                                          n_modules=n_modules, **kw)
        else:
            self.resWaist = _chain(n_modules, features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.res1(x)
        low = self.res2(F.max_pool2d(x, 2, 2))
        low = self.subHourglass(low) if self.depth > 1 else self.resWaist(low)
        low = self.res3(low)
        low = F.interpolate(low, scale_factor=2, mode="nearest")
        return up + low


class MainModel(nn.Module):
    """The full detector (reference model/hourglass_torch7.py:78-129)."""

    variant = "torch7"

    def __init__(self, n_stacks: int = N_STACKS, features: int = N_FEATURES,
                 n_joints: int = N_JOINTS, depth: int = N_DEPTH,
                 momentum: Optional[float] = 0.1, dtype=torch.float32,
                 fused: bool = False, quantize: Optional[str] = None,
                 n_modules: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_stacks, self.dtype = n_stacks, dtype
        # Train-mode forwards under autograd recompute the stem's and each
        # stack's activations in the backward (core/remat.py).
        self.remat = False
        kw = dict(momentum=momentum, dtype=dtype, fused=fused,
                  quantize=quantize)
        self.beforeHourglass = nn.Sequential(
            _conv(3, 64, 7, stride=2),
            BatchNorm2d(64, momentum=momentum),
            nn.ReLU(), ResModule(64, 128, **kw), nn.MaxPool2d(2, 2),
            ResModule(128, 128, **kw), ResModule(128, features, **kw))
        self.hgArray = nn.ModuleList(
            Hourglass(depth, features, n_modules=n_modules, **kw)
            for _ in range(n_stacks))
        self.linArray = nn.ModuleList(
            nn.Sequential(_conv(features, features, 1),
                          BatchNorm2d(features, momentum=momentum),
                          nn.ReLU())
            for _ in range(n_stacks))
        self.htmapArray = nn.ModuleList(
            _conv(features, n_joints, 1) for _ in range(n_stacks))
        self.llBarArray = nn.ModuleList(
            _conv(features, features, 1) for _ in range(n_stacks - 1))
        self.htmapBarArray = nn.ModuleList(
            _conv(n_joints, features, 1) for _ in range(n_stacks - 1))
        init_weights(self, generator)

    def stem(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> the first stack's input (NCHW,
        channels_last)."""
        dt = self.dtype
        x = images.permute(0, 3, 1, 2).to(dt).contiguous(memory_format=CL)
        pre = self.beforeHourglass
        h = torch.relu(bn_in(pre[1], conv_in(pre[0], x, dt), dt))
        h = pre[3](h)
        h = pre[5](F.max_pool2d(h, 2, 2))
        return pre[6](h)

    def stack(self, i: int, inter: torch.Tensor):
        """Stack ``i``: (its heatmaps (B, H/4, W/4, J) f32, the next
        stack's input). The last stack has no feedback convs, and its
        ``inter`` passes through."""
        dt = self.dtype
        ll = self.hgArray[i](inter)
        lin = self.linArray[i]
        ll = torch.relu(bn_in(lin[1], conv_in(lin[0], ll, dt), dt))
        htmap = conv_in(self.htmapArray[i], ll, dt)
        out = htmap.to(torch.promote_types(torch.float32, dt)) \
            .permute(0, 2, 3, 1)
        if i < self.n_stacks - 1:
            inter = (inter + conv_in(self.llBarArray[i], ll, dt)
                     + conv_in(self.htmapBarArray[i], htmap, dt))
        return out, inter

    def stack_modules(self, i: int):
        """The modules stack ``i`` runs (for placing a pipeline stage)."""
        mods = [self.hgArray[i], self.linArray[i], self.htmapArray[i]]
        if i < self.n_stacks - 1:
            mods += [self.llBarArray[i], self.htmapBarArray[i]]
        return mods

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        call = remat.runner(self)
        inter = call(self.stem, images)
        heatmaps = []
        for i in range(self.n_stacks):
            out, inter = call(self.stack, i, inter)
            heatmaps.append(out)
        return torch.stack(heatmaps, dim=0)  # (S, B, H/4, W/4, J)


@torch.no_grad()
def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> None:
    """torch's default Conv2d init (kaiming-uniform a=sqrt(5), bias
    U(+-1/sqrt(fan_in))) drawn from ``generator``, BN at gamma 1, beta 0;
    the identity blocks' unused conv_skip at zeros."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            bound = 1.0 / math.sqrt(fan_in)
            m.bias.uniform_(-bound, bound, generator=generator)
    for m in model.modules():
        if isinstance(m, ResModule) and m.in_channels == m.out_channels:
            m.conv_skip.weight.zero_()
            m.conv_skip.bias.zero_()
