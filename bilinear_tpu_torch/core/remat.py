"""Rematerialisation: a block's activations recomputed in the backward
instead of kept (the port's ``jax.checkpoint``, which JAX's
``HourglassTrainer(remat=True)`` wraps around its forward).

``checkpoint(fn, *args)`` is ``torch.utils.checkpoint.checkpoint``
(non-reentrant) with the recomputation marked: while ``recomputing()`` is
true, nothing updates a BN's running statistics
(``core/norm.py::update_running_stats`` returns at once, the fused
ResModule passes no running statistics to K3, and torch's own BN has its
buffers put back), so a rematerialised step updates them exactly once, in
the forward, as a plain step does. The recomputed forward gives the
original's values: every op of the detectors is deterministic, and none
draws random numbers.
"""
from __future__ import annotations

import contextlib

import torch
import torch.utils.checkpoint as _cp

_depth = 0


def recomputing() -> bool:
    """True inside a checkpointed block's recomputation."""
    return _depth > 0


@contextlib.contextmanager
def _recomputation():
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def checkpoint(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward."""
    return _cp.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputation()))


def runner(module):
    """How ``module``'s forward calls its blocks: through ``checkpoint``
    when its ``remat`` is set in a train-mode forward under autograd, else
    directly."""
    if module.remat and module.training and torch.is_grad_enabled():
        return checkpoint
    return lambda fn, *args: fn(*args)
