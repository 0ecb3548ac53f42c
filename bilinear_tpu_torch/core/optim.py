"""The trainers' optimizers (counterpart of ``bilinear_tpu/core/optim.py``).

- Detector: ``torch.nn.utils.clip_grad_norm_(max_norm=1)`` followed by
  ``torch.optim.RMSprop(lr=2.5e-4, alpha=0.99, eps=1e-8)``: the formulas
  that ``torch_clip_grad_norm`` and ``torch_rmsprop`` reproduce in JAX (the
  reference trains with exactly these, ``train_hourglass.py:79-81``).
- Lifting: the same clip followed by ``torch.optim.Adam(betas=(0.9, 0.999),
  eps=1e-8)`` with the reference's step-decay schedule
  (``reference_bilinear_schedule``), which ``torch_adam`` reproduces in JAX.
  The two round apart in two places: torch divides ``sqrt(v) /
  sqrt(1 - b2^t)`` where JAX takes ``sqrt(v / (1 - b2^t))``, and torch
  takes the bias corrections in float64, JAX in float32 (ROADMAP.md Queue 3
  has the measured gap).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch


class ClippedOptimizer:
    """``clip_grad_norm_(max_norm)`` of the parameters that have a gradient,
    then a torch optimizer's step. ``count`` is the number of updates (the
    JAX optimizer state's ``count``). With a ``schedule``, the rate of
    update ``count + 1`` is written into the param groups before each
    step. ``grad_norm``, when set, gives the norm to clip by (a model split
    over ranks, ``parallel/tp.py``), with ``clip_grad_norm_``'s formula."""

    grad_norm: Optional[Callable[[], torch.Tensor]] = None

    def __init__(self, params: Iterable[torch.nn.Parameter], inner,
                 max_norm: float,
                 schedule: Optional[Callable[[int], float]] = None, **kw):
        self.params = list(params)
        self.max_norm = max_norm
        self.schedule = schedule
        self.inner = inner(self.params, **kw)
        self.count = 0

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        with_grad = [p for p in self.params if p.grad is not None]
        if self.grad_norm is None:
            torch.nn.utils.clip_grad_norm_(with_grad, self.max_norm)
        else:
            coef = torch.clamp(self.max_norm / (self.grad_norm() + 1e-6),
                               max=1.0)
            torch._foreach_mul_([p.grad for p in with_grad], coef)
        if self.schedule is not None:
            lr = self.schedule(self.count + 1)
            for group in self.inner.param_groups:
                group["lr"] = lr
        self.inner.step()
        self.count += 1

    def _state(self, p: torch.nn.Parameter, *keys):
        """The inner optimizer's tensors ``keys`` of ``p``; None before its
        first update."""
        st = self.inner.state.get(p)
        return None if not st else tuple(st[k] for k in keys)

    def _set_state(self, p: torch.nn.Parameter, count: int,
                   **tensors: torch.Tensor) -> None:
        self.inner.state[p] = {"step": torch.tensor(float(count)), **{
            k: v.to(device=p.device, dtype=p.dtype).clone()
            for k, v in tensors.items()}}


class HourglassOptimizer(ClippedOptimizer):
    """clip(max_norm) -> RMSprop(lr)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float = 2.5e-4, max_norm: float = 1.0):
        super().__init__(params, torch.optim.RMSprop, max_norm,
                         lr=learning_rate, alpha=0.99, eps=1e-8)

    def square_avg(self, p: torch.nn.Parameter):
        """RMSprop's running average of g^2 for ``p`` (None before its first
        update)."""
        st = self._state(p, "square_avg")
        return None if st is None else st[0]

    def set_square_avg(self, p: torch.nn.Parameter, value: torch.Tensor,
                       count: int) -> None:
        self._set_state(p, count, square_avg=value)


def hourglass_optimizer(params, learning_rate: float = 2.5e-4,
                        max_norm: float = 1.0) -> HourglassOptimizer:
    return HourglassOptimizer(params, learning_rate, max_norm)


def reference_bilinear_schedule(base_lr: float = 1.0e-3, decay: float = 0.96,
                                period: int = 100_000
                                ) -> Callable[[int], float]:
    """The reference's step decay (``util/config.py:19-23``,
    ``train_bilinear.py:66-70``) as a function of the optimizer's update
    count, the update being made included: the rate is re-set to ``base *
    decay^(step / period)`` only at step 1 and at multiples of ``period``
    and held in between, so ``lr(step) = f(last re-set <= step)``, closed
    form and the same after a restart. Evaluated in float32, as the JAX
    package evaluates it, so both give the same float."""
    f32 = np.float32

    def schedule(count: int) -> float:
        step = max(int(count), 1)
        last = (step // period) * period if step >= period else 1
        return float(f32(base_lr) * np.power(f32(decay),
                                             f32(last) / f32(period)))

    return schedule


class BilinearOptimizer(ClippedOptimizer):
    """clip(max_norm) -> Adam with a schedule (a constant rate when
    ``learning_rate`` is a number, the reference's schedule when None)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: Union[None, float, Callable[[int], float]]
                 = None, max_norm: float = 1.0):
        if learning_rate is None:
            learning_rate = reference_bilinear_schedule()
        schedule = learning_rate if callable(learning_rate) else \
            (lambda count, lr=float(learning_rate): lr)
        super().__init__(params, torch.optim.Adam, max_norm, schedule,
                         lr=schedule(1), betas=(0.9, 0.999), eps=1e-8)

    def moments(self, p: torch.nn.Parameter):
        """Adam's (exp_avg, exp_avg_sq) of ``p``; None before its first
        update."""
        return self._state(p, "exp_avg", "exp_avg_sq")

    def set_moments(self, p: torch.nn.Parameter, exp_avg: torch.Tensor,
                    exp_avg_sq: torch.Tensor, count: int) -> None:
        self._set_state(p, count, exp_avg=exp_avg, exp_avg_sq=exp_avg_sq)


def bilinear_optimizer(params: Iterable[torch.nn.Parameter],
                       learning_rate: Optional[
                           Union[float, Callable[[int], float]]] = None,
                       max_norm: float = 1.0) -> BilinearOptimizer:
    """clip(1.0) -> Adam(1e-3, the reference's step decay); mirrors
    ``train_bilinear.py:66-83``."""
    return BilinearOptimizer(params, learning_rate, max_norm)
