"""BatchNorm with torch semantics (counterpart of
``bilinear_tpu/core/norm.py``).

The JAX package rebuilds torch's BatchNorm (``TorchBatchNorm``); here it is
``nn.BatchNorm2d(eps=1e-5, momentum=0.1)`` itself: normalisation by the
biased batch variance, the running variance updated with the unbiased one,
``momentum=None`` for the cumulative average (factor ``1 /
num_batches_tracked``). The JAX tree's ``{mean, var, count}`` are
``running_mean``, ``running_var`` and ``num_batches_tracked``.

``update_running_stats`` applies that same update to statistics computed
elsewhere (by the fused ResModule kernel), as ``_BNState`` does in
``bilinear_tpu/models/hourglass_torch7.py``.

``BatchNorm2d`` is the pre-activation hourglass's BN: cumulative from the
first step (``momentum=None``). torch's own reads ``num_batches_tracked``
on the host at every train-mode call in that mode, a wait for the card at
each of the full-width model's 377 BNs; this one takes the batch
statistics itself and updates the running ones through
``update_running_stats``, whose factor stays on the device.

The reference's eval-time recalibration (``reset_statistics()``) resets
every BN's statistics and then re-estimates them with the cumulative
average: ``reset_batch_stats`` and ``cumulative_momentum``. The JAX package
passes the momentum at call time (``TorchBatchNorm.__call__``); torch keeps
it on the module, so the context manager sets it and puts it back.

Under data parallelism JAX's train-mode BN reduces over the global batch
(GSPMD). Here a ``DataShard`` (the rows this rank holds of the global batch
and the data group) is set on every BN with ``set_data_shard``; a BN whose
shard's group has more than one rank normalises with global statistics
(``global_batch_norm``: the per-channel sums and then the squared
deviations all-reduced through the differentiable
``torch.distributed.nn.functional.all_reduce``, so the backward reduces its
per-channel sums too) and updates its running statistics with the global
``n / (n - 1)``. With no shard, or a group of one, nothing changes.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm


class DataShard:
    """This rank's rows ``[offset, offset + rows)`` of a global batch of
    ``total`` rows, and the data group that holds the others. The trainer
    sets ``offset`` and ``total`` before each forward (``place``); every
    module that was given the shard reads them then."""

    def __init__(self, group=None):
        self.group = group
        self.offset = 0
        self.total = 0

    def place(self, offset: int, total: int) -> None:
        self.offset, self.total = int(offset), int(total)

    @property
    def active(self) -> bool:
        return self.group is not None and dist.get_world_size(self.group) > 1


def active_shard(module: nn.Module) -> Optional[DataShard]:
    """The module's ``DataShard`` when its group has more than one rank."""
    shard = getattr(module, "data_shard", None)
    return shard if shard is not None and shard.active else None


def set_data_shard(model: nn.Module, shard: Optional[DataShard]) -> None:
    """Give every module of ``model`` that reads a shard (every BN, and the
    lifter's dropout layers) ``shard``; None takes it away."""
    for m in model.modules():
        if isinstance(m, _BatchNorm) or hasattr(type(m), "data_shard"):
            m.data_shard = shard


def global_batch_norm(bn: _BatchNorm, x: torch.Tensor,
                      shard: DataShard) -> torch.Tensor:
    """Train-mode BN of ``x`` (channels on dim 1) with the statistics of
    the global batch: the per-channel sums all-reduced over the shard's
    group for the mean, then the sums of squared deviations from it for the
    biased variance, both through autograd. The running statistics take
    the global mean and the unbiased variance with the global count."""
    from torch.distributed.nn.functional import all_reduce

    c = x.shape[1]
    dims = [0] + list(range(2, x.ndim))
    shape = (1, c) + (1,) * (x.ndim - 2)
    n = shard.total * math.prod(x.shape[2:])
    mean = all_reduce(x.sum(dims), group=shard.group) / n
    d = x - mean.view(shape)
    var = all_reduce(d.square().sum(dims), group=shard.group) / n
    update_running_stats(bn, mean.detach(), var.detach(), n)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    return d * inv.view(shape) + bn.bias.view(shape)


def batch_norm(bn: _BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """``bn(x)``, or in train mode under a data group of more than one
    rank, ``global_batch_norm``."""
    shard = active_shard(bn) if bn.training else None
    return bn(x) if shard is None else global_batch_norm(bn, x, shard)


@torch.no_grad()
def update_running_stats(bn: _BatchNorm, batch_mean: torch.Tensor,
                         batch_var: torch.Tensor, n: int) -> None:
    """In place: count += 1, then ``r = (1 - f) r + f batch`` for the mean
    and for the unbiased variance ``var * n / (n - 1)``, with ``f =
    momentum`` or, for ``momentum=None``, ``1 / count`` in f32 (as the JAX
    package computes it), a tensor on the counter's device: reading the
    counter on the host would wait for the card at every BN."""
    unbiased = batch_var * (n / max(n - 1, 1))
    bn.num_batches_tracked += 1
    if bn.momentum is None:
        factor = 1.0 / bn.num_batches_tracked.to(bn.running_mean.dtype)
    else:
        factor = bn.momentum
    bn.running_mean.mul_(1 - factor).add_(factor * batch_mean)
    bn.running_var.mul_(1 - factor).add_(factor * unbiased)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (the same parameters, buffers and state_dict
    keys) whose train-mode forward never reads the card on the host: the
    batch mean and biased variance in one pass, the input normalised with
    them, the running statistics updated by ``update_running_stats`` (the
    unbiased variance, the cumulative factor ``1 / count`` in f32 on the
    device for ``momentum=None``). Eval mode is torch's."""

    def __init__(self, num_features: int, momentum=None, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        shard = active_shard(self)
        if shard is not None:
            return global_batch_norm(self, x, shard)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        n = x.numel() // x.shape[1]
        update_running_stats(self, mean.detach(), var.detach(), n)
        shape = (1, -1, 1, 1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)


def _batch_norms(model: nn.Module) -> Iterator[_BatchNorm]:
    return (m for m in model.modules() if isinstance(m, _BatchNorm))


@torch.no_grad()
def reset_batch_stats(model: nn.Module) -> None:
    """In place, every BN of ``model``: running mean 0, running variance 1,
    ``num_batches_tracked`` 0 (``reset_batch_stats`` of the JAX package)."""
    for bn in _batch_norms(model):
        bn.reset_running_stats()


@contextlib.contextmanager
def cumulative_momentum(model: nn.Module):
    """Every BN of ``model`` with ``momentum=None`` (the cumulative average)
    inside the block; the old momenta are restored on exit."""
    bns = list(_batch_norms(model))
    old = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = None
    try:
        yield model
    finally:
        for bn, m in zip(bns, old):
            bn.momentum = m
