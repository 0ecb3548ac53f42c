"""Graceful preemption for the training CLIs (the port's copy of
``bilinear_tpu/utils/preempt.py``).

A managed fleet delivers SIGTERM ahead of reclaiming a machine. The
reference's crash story is restart-from-newest-checkpoint: a kill loses the
whole in-flight ``epochs_per_run`` block. This narrows the loss to the
current epoch: on SIGTERM/SIGINT the trainer finishes the epoch it is in,
checkpoints it as usual, and exits 0; the next invocation's auto-resume
continues from there.

Epoch granularity is deliberate: checkpoints are tagged by whole epochs
(``io/checkpoint.py``) and the resume contract assumes a fully trained
epoch.
"""
from __future__ import annotations

import signal

import torch
import torch.distributed as dist


class GracefulShutdown:
    """Context manager: latch SIGTERM/SIGINT instead of dying mid-epoch.

    Usage::

        with GracefulShutdown(logger) as stop:
            for epoch in ...:
                train_one_epoch(); save_checkpoint()
                if global_requested(stop.requested):
                    break

    The first signal sets ``requested``; a second signal of the same kind
    falls through to the previous (default) handler, so a double Ctrl-C
    still kills a stuck process. Handlers are restored on exit. Outside
    the main thread no handler can be installed, and none is.
    """

    def __init__(self, logger=None, signals=(signal.SIGTERM, signal.SIGINT)):
        self._logger = logger
        self._signals = signals
        self._previous = {}
        self.requested = False
        # Logged from the main loop: logging is not async-signal-safe, so
        # the handler only sets flags.
        self._pending_signame = None

    def _handle(self, signum, frame):
        self.requested = True
        self._pending_signame = signal.Signals(signum).name
        # Re-arm the previous handler: a second signal is an actual kill.
        # signal.signal() reports None for a handler installed by C code:
        # fall back to the default disposition.
        prev = self._previous.get(signum) or signal.SIG_DFL
        signal.signal(signum, prev)

    def log_pending(self) -> None:
        """Emit the deferred 'preemption received' line; called by the
        trainers at their next epoch-end check."""
        if self._pending_signame and self._logger is not None:
            self._logger.info(
                "%s received - finishing the current epoch, checkpointing, "
                "then exiting (auto-resume continues from there)",
                self._pending_signame,
            )
            self._pending_signame = None

    def __enter__(self):
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except ValueError:  # not in the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev or signal.SIG_DFL)
            except ValueError:
                pass
        return False


def global_requested(local: bool, group=None) -> bool:
    """Agree on preemption across the ranks of a multi-process run.

    A SIGTERM usually reaches only some processes; if those exited alone
    the rest would hang in the next epoch's collectives. Stop when ANY rank
    was signalled: the flags are all-reduced with MAX over ``group`` (the
    world when None), which doubles as the agreement barrier. Without a
    process group the local flag is the answer.
    """
    if not dist.is_initialized():
        return bool(local)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    flag = torch.tensor([int(bool(local))], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())
