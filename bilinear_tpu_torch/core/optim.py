"""The detector's optimizer (counterpart of
``bilinear_tpu/core/optim.py::hourglass_optimizer``).

``torch.nn.utils.clip_grad_norm_(max_norm=1)`` followed by
``torch.optim.RMSprop(lr=2.5e-4, alpha=0.99, eps=1e-8)``: the formulas that
``torch_clip_grad_norm`` and ``torch_rmsprop`` reproduce in JAX (the
reference trains with exactly these, ``train_hourglass.py:79-81``).
"""
from __future__ import annotations

from typing import Iterable

import torch


class HourglassOptimizer:
    """clip(max_norm) -> RMSprop(lr). ``count`` is the number of updates,
    the JAX ``TorchRMSpropState.count``."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float = 2.5e-4, max_norm: float = 1.0):
        self.params = list(params)
        self.max_norm = max_norm
        self.rmsprop = torch.optim.RMSprop(self.params, lr=learning_rate,
                                           alpha=0.99, eps=1e-8)
        self.count = 0

    def zero_grad(self) -> None:
        self.rmsprop.zero_grad(set_to_none=True)

    def step(self) -> None:
        with_grad = [p for p in self.params if p.grad is not None]
        torch.nn.utils.clip_grad_norm_(with_grad, self.max_norm)
        self.rmsprop.step()
        self.count += 1

    def square_avg(self, p: torch.nn.Parameter):
        """RMSprop's running average of g^2 for ``p`` (None before its first
        update)."""
        st = self.rmsprop.state.get(p)
        return None if not st else st["square_avg"]

    def set_square_avg(self, p: torch.nn.Parameter, value: torch.Tensor,
                       count: int) -> None:
        self.rmsprop.state[p] = {
            "step": torch.tensor(float(count)),
            "square_avg": value.to(device=p.device,
                                   dtype=p.dtype).clone(),
        }


def hourglass_optimizer(params, learning_rate: float = 2.5e-4,
                        max_norm: float = 1.0) -> HourglassOptimizer:
    return HourglassOptimizer(params, learning_rate, max_norm)
