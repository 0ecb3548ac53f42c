"""Torch-parity parameter initializers (counterpart of
``bilinear_tpu/core/initializers.py``).

The reference initializes Linear weights with ``kaiming_normal`` and leaves
biases at torch's default ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``. The JAX
package reproduces those distributions with JAX's RNG; here they are torch's
own init functions. The two match in distribution, not bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def kaiming_normal(weight: torch.Tensor, a: float = 0.0,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """In place: ``N(0, gain/sqrt(fan_in))`` with the leaky-relu gain
    ``sqrt(2/(1+a^2))``. ``weight`` is a torch Linear weight ``(out, in)``."""
    fan_in = weight.shape[1]
    std = math.sqrt(2.0 / (1.0 + a * a)) / math.sqrt(fan_in)
    with torch.no_grad():
        return weight.normal_(0.0, std, generator=generator)


def torch_bias_init(bias: torch.Tensor, fan_in: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """In place: torch's default Linear bias, ``U(-1/sqrt(fan_in), +...)``."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        return bias.uniform_(-bound, bound, generator=generator)


def init_linear(linear: nn.Linear,
                generator: Optional[torch.Generator] = None) -> None:
    """The reference's Linear init: kaiming-normal weight, default bias."""
    kaiming_normal(linear.weight, generator=generator)
    if linear.bias is not None:
        torch_bias_init(linear.bias, linear.in_features, generator=generator)
