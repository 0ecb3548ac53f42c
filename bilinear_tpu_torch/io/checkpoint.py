"""Checkpoints with the reference's directory contract (counterpart of the
``.save`` half of ``bilinear_tpu/io/checkpoint.py``).

Layout: ``{run_dir}/parameter/{epoch}.save``, a pickle of
``{'epoch', 'step', 'state': {'params', 'batch_stats'}, 'optimizer'}`` whose
``params``/``batch_stats`` are the JAX package's parameter tree as plain
numpy dicts and ``optimizer`` the JAX optimizer state as the same
(``flax.serialization.to_state_dict`` of it). The port reads checkpoints
that the JAX trainer wrote and writes ones in the same layout, without
importing JAX; models convert through ``utils/weights.py``. Resume reads
the newest epoch; ``-1`` is the "finalized" sentinel (``mark_finalized``:
the detector's BN statistics after the one-time recalibration of
``eval_hourglass``), which never wins the scan and is loaded by its epoch.
``{epoch}.orbax`` directories are recognised by the scan but not readable
here, and the JAX package's asynchronous save is not ported either.

The payload is a pickle: load only checkpoints this project wrote.
"""
from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

FINALIZED_EPOCH = -1


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
    """Load ``{epoch}.save`` (``FINALIZED_EPOCH`` for the sentinel). An
    ``{epoch}.orbax`` checkpoint raises: that backend is not ported."""
    path = os.path.join(parameter_dir, f"{epoch}.save")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    if os.path.isdir(os.path.join(parameter_dir, f"{epoch}.orbax")):
        raise NotImplementedError(
            "Orbax checkpoints are not ported (nor is the asynchronous "
            "save); see ROADMAP.md"
        )
    raise FileNotFoundError(
        f"no checkpoint for epoch {epoch} in {parameter_dir} "
        "(neither .save nor .orbax)"
    )


def save_checkpoint(parameter_dir: str, epoch: int,
                    params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                    optimizer: Optional[Mapping[str, Any]] = None,
                    step: int = 1) -> str:
    """Write ``{epoch}.save`` from JAX-layout numpy trees: ``params``,
    ``batch_stats`` and the optimizer state (``{}`` when there is none, as
    for a served model). The write is atomic (per-process tmp file +
    rename)."""
    os.makedirs(parameter_dir, exist_ok=True)
    payload = {
        "epoch": epoch,
        "step": int(step),
        "state": {"params": params, "batch_stats": batch_stats},
        "optimizer": {} if optimizer is None else optimizer,
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


def mark_finalized(parameter_dir: str, params: Mapping[str, Any],
                   batch_stats: Mapping[str, Any],
                   optimizer: Optional[Mapping[str, Any]] = None,
                   step: int = 1) -> str:
    """Write the ``-1.save`` 'training over' sentinel
    (``eval_hourglass.py:47-57`` of the reference), arguments as for
    ``save_checkpoint``."""
    return save_checkpoint(parameter_dir, FINALIZED_EPOCH, params,
                           batch_stats, optimizer, step)


def is_finalized(parameter_dir: str) -> bool:
    return os.path.exists(os.path.join(parameter_dir,
                                       f"{FINALIZED_EPOCH}.save"))


def resume_or_init(state, parameter_dir: Optional[str]):
    """The reference's load() contract: restore ``state`` in place from the
    newest epoch's payload (``state.restore(payload)``) when a checkpoint
    exists. Returns (state, start_epoch), start_epoch 0 for a fresh run."""
    epoch = latest_epoch(parameter_dir)
    if epoch > 0:
        state.restore(load_checkpoint(parameter_dir, epoch))
    return state, max(epoch, 0)


def prune_checkpoints(parameter_dir: str, keep_last: int,
                      keep_every: int = 0) -> list:
    """Delete old epoch checkpoints, keeping the newest ``keep_last``, every
    ``keep_every``-th epoch, the ``-1`` sentinel and anything that is not an
    epoch checkpoint; the newest epoch always stays. ``keep_last <= 0`` and
    ``keep_every <= 0`` keep everything. Returns the removed paths."""
    if keep_last <= 0 and keep_every <= 0:
        return []
    epochs: Dict[int, list] = {}
    for e, path in _epoch_files(parameter_dir):
        if e != FINALIZED_EPOCH:
            epochs.setdefault(e, []).append(path)
    keep = set(sorted(epochs)[-max(keep_last, 1):])
    if keep_every > 0:
        keep |= {e for e in epochs if e % keep_every == 0}
    removed = []
    for e, paths in epochs.items():
        if e in keep:
            continue
        for p in paths:
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.remove(p)
            removed.append(p)
    return removed
