"""Bilinear residual lifting MLP, 2D keypoints (32-d) -> 3D pose (48-d)
(counterpart of ``bilinear_tpu/models/bilinear.py``).

Linear(32->1024) encoder block, two residual blocks of two
Linear->BatchNorm->ReLU->Dropout(0.5) sub-blocks with an additive skip, and
a Linear(1024->48) decoder: 4.3 M parameters. The ``state_dict`` keys are the
reference's (``encode.0.*`` Linear, ``encode.1.*`` BN,
``bilinear.{b}.{s}.{0,1}.*``, ``decode.*``), so ``utils/weights.py`` carries
weights to and from the JAX package's parameter tree.

The JAX package's ``TorchBatchNorm`` re-implements torch's own
``BatchNorm1d`` semantics, so this module uses ``nn.BatchNorm1d`` directly
(eps 1e-5, momentum 0.1; the JAX ``count`` is ``num_batches_tracked``).

Precision as in JAX: parameters are f32; each Linear runs in ``dtype``
(input and weight cast, the product rounded to ``dtype``, the bias rounded
to ``dtype`` and added in ``dtype``), BN runs in f32 and is rounded back to
``dtype``, and the output is f32 (f64 throughout for a model in f64, the
tests' exact reference). The casts are explicit, no autocast.

Train-mode dropout draws its keep mask from the ``generator`` passed to
``forward`` (on the activations' device), never from torch's global RNG:
``x / (1 - p)`` where ``rand < 1 - p``, else 0, as flax's ``Dropout``.

Under data parallelism (``core/norm.py::set_data_shard``) the BNs take the
global batch's statistics, and each dropout layer draws the mask of the
whole global batch and keeps this rank's rows, so a step over the ranks
draws what one process draws.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bilinear_tpu_torch.core.initializers import init_linear
from bilinear_tpu_torch.core.norm import active_shard, batch_norm
from bilinear_tpu_torch.core.precision import wide

NUM_JOINTS = 17 - 1
IN_FEATURES = 2 * NUM_JOINTS  # 32
OUT_FEATURES = 3 * NUM_JOINTS  # 48


def linear_in(linear: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """The Linear in ``dtype``: round(x @ W^T) + round(b), in ``dtype``."""
    return F.linear(x.to(dtype), linear.weight.to(dtype)) + \
        linear.bias.to(dtype)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator],
            window=None) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator``; identity in
    eval mode or at ``p == 0``. ``window``: (shape, index), the mask drawn
    at the global ``shape`` and ``x``'s part of it taken by ``index``."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("train-mode dropout needs an explicit "
                         "torch.Generator on the activations' device")
    keep = 1.0 - p
    shape, index = (x.shape, ...) if window is None else window
    mask = torch.rand(shape, generator=generator, device=x.device)[index] \
        < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def row_window(x: torch.Tensor, shard):
    """The dropout window of a rank's rows of the global batch (None
    without an active shard)."""
    if shard is None:
        return None
    return ((shard.total,) + tuple(x.shape[1:]),
            slice(shard.offset, shard.offset + x.shape[0]))


class HeavyLinear(nn.Sequential):
    """Linear -> BatchNorm1d -> ReLU -> Dropout."""

    data_shard = None  # core/norm.py::set_data_shard

    def __init__(self, in_features: int, features: int,
                 dropout: float = 0.5, bn_momentum: Optional[float] = 0.1,
                 dtype=torch.float32):
        super().__init__(
            nn.Linear(in_features, features),
            nn.BatchNorm1d(features, eps=1e-5, momentum=bn_momentum),
            nn.ReLU(),
            nn.Dropout(dropout),
        )
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lin, bn, _, drop = self
        h = linear_in(lin, x, self.dtype)
        h = torch.relu(batch_norm(bn, h.to(wide(self.dtype)))
                       .to(self.dtype))
        return dropout(h, drop.p, self.training, generator,
                       row_window(h, active_shard(self)))


class BilinearUnit(nn.Module):
    """The lifting network. ``generator`` seeds the reference init
    (kaiming-normal weights, torch-default biases); ``dtype`` is the compute
    type of the Linears."""

    def __init__(self, hidden: int = 1024, num_blocks: int = 2,
                 dropout: float = 0.5, bn_momentum: Optional[float] = 0.1,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encode = HeavyLinear(IN_FEATURES, hidden, dropout, bn_momentum,
                                  dtype)
        self.bilinear = nn.ModuleList(
            nn.ModuleList(
                HeavyLinear(hidden, hidden, dropout, bn_momentum, dtype)
                for _ in range(2)
            )
            for _ in range(num_blocks)
        )
        self.decode = nn.Linear(hidden, OUT_FEATURES)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear(m, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, 32) -> (N, 48) f32. ``generator`` draws the train-mode
        dropout masks, in layer order."""
        x = self.encode(x.to(self.dtype), generator)
        for block in self.bilinear:
            skip = x
            for layer in block:
                x = layer(x, generator)
            x = x + skip
        return linear_in(self.decode, x, self.dtype).to(wide(self.dtype))
