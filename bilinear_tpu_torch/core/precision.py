"""The models' precision rule, as in JAX: parameters are f32; a conv runs in
the model's ``dtype``, a BN in f32 (f64 for a model in f64) on the rounded
conv output, rounded back to ``dtype``. Each model imports these names into
its own namespace, so patching a model module's ``bn_in`` changes what that
model runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bilinear_tpu_torch.core import remat
from bilinear_tpu_torch.core.norm import BatchNorm2d, active_shard

CL = torch.channels_last


def wide(dtype) -> torch.dtype:
    """BN's and the outputs' type: f32, or f64 for a model in f64."""
    return torch.promote_types(torch.float32, dtype)


def conv_in(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """The conv in ``dtype``: round(conv(x, W)) + round(b), in ``dtype``
    (a bias-free conv adds nothing)."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                 conv.padding)
    if conv.bias is None:
        return y
    return y + conv.bias.to(dtype).view(1, -1, 1, 1)


def bn_in(bn: BatchNorm2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """BN in f32 (f64 for a model in f64) on the ``dtype`` activation,
    rounded back to ``dtype``: torch's own on the card (cuDNN), ``bn``'s own
    formulation on the CPU and under a data group of more than one rank
    (the global batch's statistics). torch's CPU BN backward loses the
    per-channel sums when the upstream gradient has a large mean, as
    End2End's soft-argmax gives it, where cuDNN's keeps them."""
    x = x.to(wide(dtype))
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
