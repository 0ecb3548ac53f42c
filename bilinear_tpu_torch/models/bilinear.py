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
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bilinear_tpu_torch.core.initializers import init_linear

NUM_JOINTS = 17 - 1
IN_FEATURES = 2 * NUM_JOINTS  # 32
OUT_FEATURES = 3 * NUM_JOINTS  # 48


class HeavyLinear(nn.Sequential):
    """Linear -> BatchNorm1d -> ReLU -> Dropout."""

    def __init__(self, in_features: int, features: int,
                 dropout: float = 0.5, bn_momentum: Optional[float] = 0.1):
        super().__init__(
            nn.Linear(in_features, features),
            nn.BatchNorm1d(features, eps=1e-5, momentum=bn_momentum),
            nn.ReLU(),
            nn.Dropout(dropout),
        )


class BilinearUnit(nn.Module):
    """The lifting network. ``generator`` seeds the reference init
    (kaiming-normal weights, torch-default biases)."""

    def __init__(self, hidden: int = 1024, num_blocks: int = 2,
                 dropout: float = 0.5, bn_momentum: Optional[float] = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encode = HeavyLinear(IN_FEATURES, hidden, dropout, bn_momentum)
        self.bilinear = nn.ModuleList(
            nn.ModuleList(
                HeavyLinear(hidden, hidden, dropout, bn_momentum)
                for _ in range(2)
            )
            for _ in range(num_blocks)
        )
        self.decode = nn.Linear(hidden, OUT_FEATURES)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear(m, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encode(x)
        for block in self.bilinear:
            skip = x
            for layer in block:
                x = layer(x)
            x = x + skip
        return self.decode(x)
