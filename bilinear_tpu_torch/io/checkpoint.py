"""Checkpoints with the reference's directory contract (counterpart of the
``.save`` half of ``bilinear_tpu/io/checkpoint.py``).

Layout: ``{run_dir}/parameter/{epoch}.save``, a pickle of
``{'epoch', 'step', 'state': {'params', 'batch_stats'}, 'optimizer'}`` whose
``params``/``batch_stats`` are the JAX package's parameter tree as plain
numpy dicts. The port reads checkpoints that the JAX trainer wrote and
writes ones in the same layout, without importing JAX. ``{epoch}.orbax``
directories are recognised by the scan but not readable here.

The payload is a pickle: load only checkpoints this project wrote.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

from bilinear_tpu_torch.utils.weights import bilinear_to_jax


def _epoch_files(parameter_dir: Optional[str]) -> Iterator[Tuple[int, str]]:
    """Yield ``(epoch, path)`` for every ``{epoch}.save`` pickle and
    ``{epoch}.orbax`` directory in the dir."""
    if not (parameter_dir and os.path.isdir(parameter_dir)):
        return
    for fname in os.listdir(parameter_dir):
        stem, _, ext = fname.partition(".")
        if ext not in ("save", "orbax"):
            continue
        try:
            e = int(stem)
        except ValueError:
            continue
        yield e, os.path.join(parameter_dir, fname)


def latest_epoch(parameter_dir: Optional[str]) -> int:
    """Max integer epoch present, 0 if none (``-1``, the 'finalized'
    sentinel, never wins)."""
    return max((e for e, _ in _epoch_files(parameter_dir)), default=0)


def load_checkpoint(parameter_dir: str, epoch: int) -> Dict[str, Any]:
    """Load ``{epoch}.save``. An ``{epoch}.orbax`` checkpoint raises: that
    backend is not ported."""
    path = os.path.join(parameter_dir, f"{epoch}.save")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    if os.path.isdir(os.path.join(parameter_dir, f"{epoch}.orbax")):
        raise NotImplementedError(
            "Orbax checkpoints are not ported; see ROADMAP.md"
        )
    raise FileNotFoundError(
        f"no checkpoint for epoch {epoch} in {parameter_dir} "
        "(neither .save nor .orbax)"
    )


def save_checkpoint(parameter_dir: str, epoch: int,
                    state_dict: Mapping[str, Any], step: int = 1) -> str:
    """Write ``{epoch}.save`` from a port ``BilinearUnit`` state_dict, in the
    JAX package's payload layout (params/batch_stats via ``bilinear_to_jax``).

    Until the training slice the port has no optimizer, so ``optimizer`` is
    written as ``{}``. The write is atomic (per-process tmp file + rename)."""
    os.makedirs(parameter_dir, exist_ok=True)
    params, batch_stats = bilinear_to_jax(state_dict)
    payload = {
        "epoch": epoch,
        "step": int(step),
        "state": {"params": params, "batch_stats": batch_stats},
        "optimizer": {},
    }
    path = os.path.join(parameter_dir, f"{epoch}.save")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
