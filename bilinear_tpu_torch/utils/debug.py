"""Debug mode for the training CLIs' ``--debug-nans`` (counterpart of
``bilinear_tpu/utils/debug.py``).

JAX's ``jax_debug_nans`` traps the first op that makes a NaN. Here:

- ``debug_mode(model)``: inside it, every module's forward output is
  checked and a non-finite one raises ``FloatingPointError`` naming the
  module (its name in ``model``), and ``torch.autograd.detect_anomaly``
  (``check_nan=True``) checks every backward node. The fused ResModule's
  kernels (K3/K4) are one autograd Function: ``ops/resmodule.py`` checks
  K3's outputs (the block's output and batch statistics) and K4's (g_x and
  every parameter gradient) itself, through ``check``, and names the block.
  Each check reads the card on the host; outside debug mode nothing is
  checked and nothing is read.
- ``tree_all_finite`` / ``assert_tree_finite``: the same checks on a tree
  (dicts, lists, tuples) of tensors or arrays, the offending leaf paths in
  the message.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch
from torch import nn

_active = 0
_where: List[str] = []  # the modules whose forward is running, outermost first


def active() -> bool:
    return _active > 0


def where() -> str:
    """The innermost module whose forward is running (debug mode only)."""
    return _where[-1] if _where else "?"


def check(tensors, what: str) -> None:
    """In debug mode, raise ``FloatingPointError`` naming ``what`` when a
    floating tensor of ``tensors`` holds a NaN or an infinity."""
    if not active():
        return
    bad = [i for i, t in enumerate(tensors)
           if t is not None and t.is_floating_point()
           and not bool(torch.isfinite(t).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {what} "
                                 f"(outputs {bad})")


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensors(o)]
    return []


@contextlib.contextmanager
def debug_mode(model: Optional[nn.Module] = None):
    """Check every module's forward output and every backward node for
    NaNs and infinities while the block runs; modules are named by their
    path in ``model`` (by class elsewhere)."""
    global _active
    names = {id(m): n or type(m).__name__
             for n, m in (model.named_modules() if model is not None
                          else ())}

    def name_of(m):
        return names.get(id(m), type(m).__name__)

    def pre(m, args):
        _where.append(name_of(m))

    def post(m, args, out):
        _where.pop()
        check(_tensors(out), f"the output of {name_of(m)}")

    hooks = [nn.modules.module.register_module_forward_pre_hook(pre),
             nn.modules.module.register_module_forward_hook(post)]
    _active += 1
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    finally:
        _active -= 1
        _where.clear()
        for h in hooks:
            h.remove()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(x) -> Optional[bool]:
    """Whether a floating leaf is all finite; None for any other leaf."""
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all()) if x.is_floating_point() \
            else None
    if hasattr(x, "dtype") and np.issubdtype(np.asarray(x).dtype,
                                             np.floating):
        return bool(np.isfinite(np.asarray(x)).all())
    return None


def tree_all_finite(tree) -> bool:
    """Every floating leaf of the tree is finite."""
    return all(_finite(x) is not False for _, x in _leaves(tree))


def assert_tree_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` with the offending leaf paths."""
    bad = [p for p, x in _leaves(tree) if _finite(x) is False]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
