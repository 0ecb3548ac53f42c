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
"""
from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, batch_mean: torch.Tensor,
                         batch_var: torch.Tensor, n: int) -> None:
    """In place: count += 1, then ``r = (1 - f) r + f batch`` for the mean
    and for the unbiased variance ``var * n / (n - 1)``, with ``f =
    momentum`` or, for ``momentum=None``, ``1 / count``."""
    unbiased = batch_var * (n / max(n - 1, 1))
    bn.num_batches_tracked += 1
    if bn.momentum is None:
        factor = 1.0 / float(bn.num_batches_tracked)
    else:
        factor = bn.momentum
    bn.running_mean.copy_((1 - factor) * bn.running_mean + factor * batch_mean)
    bn.running_var.copy_((1 - factor) * bn.running_var + factor * unbiased)
