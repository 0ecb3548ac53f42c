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
``save_checkpoint(..., async_save=True)`` copies the trees to host memory
and writes the file on a background thread (``wait_for_async_saves`` before
exiting). ``{epoch}.orbax`` directories are recognised by the scan but not
readable here: the port does not depend on the orbax package.

The payload is a pickle: load only checkpoints this project wrote.
"""
from __future__ import annotations

import copy
import os
import pickle
import shutil
import threading
from typing import (Any, Dict, Iterator, List, Mapping, MutableMapping,
                    Optional, Tuple)

import numpy as np
import torch

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
            "Orbax checkpoints are not readable by the port, which does not "
            "depend on the orbax package; see ROADMAP.md"
        )
    raise FileNotFoundError(
        f"no checkpoint for epoch {epoch} in {parameter_dir} "
        "(neither .save nor .orbax)"
    )


def _host_copy(tree, memo=None):
    """``tree`` with every array and tensor copied: the trainers' numpy
    trees share memory with tensors the optimizer updates in place
    (``Tensor.numpy()``). Containers keep their types (an ``OrderedDict``
    state_dict, a named tuple), an array its memory order, a tensor its
    device, storage layout and storage sharing, and a leaf met twice is
    copied once, so the copy pickles as the tree would: numpy trees to the
    same bytes (a tensor's pickle also names its storage's address)."""
    memo = {} if memo is None else memo
    if id(tree) in memo:
        return memo[id(tree)]
    if isinstance(tree, MutableMapping):
        out = copy.copy(tree)
        for k, v in tree.items():
            out[k] = _host_copy(v, memo)
    elif isinstance(tree, Mapping):
        out = type(tree)({k: _host_copy(v, memo) for k, v in tree.items()})
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = type(tree)(*(_host_copy(v, memo) for v in tree))
    elif isinstance(tree, (list, tuple)):
        out = type(tree)(_host_copy(v, memo) for v in tree)
    elif isinstance(tree, np.ndarray):
        out = tree.copy(order="A")
    elif isinstance(tree, torch.Tensor):
        out = _tensor_copy(tree, memo)
    else:
        return tree
    memo[id(tree)] = out
    return out


def _tensor_copy(t: torch.Tensor, memo: Dict) -> torch.Tensor:
    """``t`` on a copy of its storage (one copy per storage), same offset,
    size, stride, device and requires_grad; a Parameter stays one."""
    storage = t.untyped_storage()
    key = ("storage", t.device, storage.data_ptr())
    if key not in memo:
        memo[key] = storage.clone()
    with torch.no_grad():
        out = torch.empty(0, dtype=t.dtype, device=t.device).set_(
            memo[key], t.storage_offset(), t.size(), t.stride())
    if isinstance(t, torch.nn.Parameter):
        return torch.nn.Parameter(out, requires_grad=t.requires_grad)
    return out.requires_grad_(t.requires_grad)


_async_lock = threading.Lock()
_async_threads: List[threading.Thread] = []
_async_errors: List[BaseException] = []


def _write(path: str, payload: Dict[str, Any]) -> None:
    """Pickle ``payload`` to ``path`` atomically: a per-process tmp file
    (two processes sharing a directory never write one file), then a
    rename. Writes are serialised by one lock."""
    with _async_lock:
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def save_checkpoint(parameter_dir: str, epoch: int,
                    params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                    optimizer: Optional[Mapping[str, Any]] = None,
                    step: int = 1, async_save: bool = False) -> str:
    """Write ``{epoch}.save`` from JAX-layout numpy trees: ``params``,
    ``batch_stats`` and the optimizer state (``{}`` when there is none, as
    for a served model). The write is atomic (per-process tmp file +
    rename). With ``async_save`` the trees are copied to host memory before
    the call returns, so that training may update them at once, and a
    background thread writes the file; ``wait_for_async_saves`` waits for
    every such write."""
    os.makedirs(parameter_dir, exist_ok=True)
    payload = {
        "epoch": epoch,
        "step": int(step),
        "state": {"params": params, "batch_stats": batch_stats},
        "optimizer": {} if optimizer is None else optimizer,
    }
    path = os.path.join(parameter_dir, f"{epoch}.save")
    if not async_save:
        _write(path, payload)
        return path
    payload = _host_copy(payload)

    def write():
        try:
            _write(path, payload)
        except BaseException as e:  # raised again by wait_for_async_saves
            _async_errors.append(e)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    _async_threads.append(t)
    return path


def wait_for_async_saves() -> None:
    """Wait until every asynchronous save of this process is written; a
    save that failed raises its error here."""
    while _async_threads:
        _async_threads.pop(0).join()
    if _async_errors:
        err = _async_errors[0]
        _async_errors.clear()
        raise err


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
