"""Carry ``BilinearUnit`` weights between the JAX package's parameter tree
and the port's ``state_dict`` (the port's own copy of the bilinear half of
``bilinear_tpu/utils/torch_compat.py``).

JAX tree -> state_dict:
- Dense ``kernel`` (in, out)            -> Linear ``weight`` (out, in)
- BN ``scale``/``bias`` (params)        -> BN ``weight``/``bias``
- BN ``mean``/``var``/``count`` (stats) -> ``running_mean``/``running_var``/
                                           ``num_batches_tracked``
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

NUM_BLOCKS = 2


def _layers() -> Iterator[Tuple[str, str]]:
    """(JAX module name, state_dict prefix) of every HeavyLinear, in the
    reference's registration order."""
    yield "encode", "encode"
    for b in range(NUM_BLOCKS):
        for s in range(2):
            yield f"bilinear_{b}_{s}", f"bilinear.{b}.{s}"


def _tensor(a) -> torch.Tensor:
    # Copy: the tree may hold read-only or shared numpy buffers.
    return torch.from_numpy(np.array(np.asarray(a)))


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.array(t)


def bilinear_from_jax(params: Mapping[str, Any],
                      batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``{params, batch_stats}`` (numpy leaves) -> port ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for ours, theirs in _layers():
        lin, bn, st = params[ours]["linear"], params[ours]["bn"], batch_stats[ours]["bn"]
        sd[f"{theirs}.0.weight"] = _tensor(np.asarray(lin["kernel"]).T)
        sd[f"{theirs}.0.bias"] = _tensor(lin["bias"])
        sd[f"{theirs}.1.weight"] = _tensor(bn["scale"])
        sd[f"{theirs}.1.bias"] = _tensor(bn["bias"])
        sd[f"{theirs}.1.running_mean"] = _tensor(st["mean"])
        sd[f"{theirs}.1.running_var"] = _tensor(st["var"])
        sd[f"{theirs}.1.num_batches_tracked"] = torch.tensor(
            int(np.asarray(st["count"])), dtype=torch.int64
        )
    sd["decode.weight"] = _tensor(np.asarray(params["decode"]["kernel"]).T)
    sd["decode.bias"] = _tensor(params["decode"]["bias"])
    return sd


def bilinear_to_jax(state_dict: Mapping[str, Any]):
    """Port ``state_dict`` -> JAX ``(params, batch_stats)`` as numpy trees.
    Exact inverse of ``bilinear_from_jax`` (``count`` comes back int32, the
    JAX package's dtype)."""
    sd = state_dict
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for ours, theirs in _layers():
        params[ours] = {
            "linear": {
                "kernel": _numpy(sd[f"{theirs}.0.weight"]).T.copy(),
                "bias": _numpy(sd[f"{theirs}.0.bias"]),
            },
            "bn": {
                "scale": _numpy(sd[f"{theirs}.1.weight"]),
                "bias": _numpy(sd[f"{theirs}.1.bias"]),
            },
        }
        stats[ours] = {
            "bn": {
                "mean": _numpy(sd[f"{theirs}.1.running_mean"]),
                "var": _numpy(sd[f"{theirs}.1.running_var"]),
                "count": _numpy(sd[f"{theirs}.1.num_batches_tracked"]).astype(
                    np.int32
                ),
            }
        }
    params["decode"] = {
        "kernel": _numpy(sd["decode.weight"]).T.copy(),
        "bias": _numpy(sd["decode.bias"]),
    }
    return params, stats
