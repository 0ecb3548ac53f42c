"""Train the bilinear lifting network on H36M (counterpart of
``bilinear_tpu/cli/train_bilinear.py``; the reference's train_bilinear.py
entry point), on the GPU.

Usage: python -m bilinear_tpu_torch.cli.train_bilinear [--data-dir
       data/Human3.6M --protocol GT --batch-size 64 --epochs-per-run 10
       --comment "Bilinear GT" --dtype bfloat16 ...]

Runs ``epochs_per_run`` epochs, resuming from the newest ``{epoch}.save``
in ``{save_root}/{comment}/parameter`` (either package's), and writes one
checkpoint per epoch in the JAX package's payload layout (then prunes, as
``--keep-checkpoints`` / ``--keep-every`` say), the per-step ``BI/loss``
scalars and ``debug.log``. The trainer runs on the card; ``--device cpu``
runs the plain PyTorch path and is meant for tests only. ``--profile
true`` writes a ``torch.profiler`` trace of the run under
``{save_root}/{comment}/plugins/profile/`` (``utils/profiling.py``);
``--debug-nans true`` checks every module's output and every backward node
(``utils/debug.py``); SIGTERM or SIGINT finishes the epoch, checkpoints it
and exits 0 (``utils/preempt.py``; over ranks, one signalled rank stops
them all after that epoch).

Multi-process: ``--coordinator host:port --num-processes N --process-id i``
on every process, and ``--local-processes L`` when the ranks span hosts,
numbered host by host (rank i on ``cuda:{(i % L) % cards}`` unless
``--device``; ``nccl`` when each rank of a host has a card of its own,
``gloo`` otherwise: ``parallel/mesh.py::rank_layout``).
Every rank loads the whole split and trains on its rows of each global
batch; ``--model-parallel M`` splits the network over groups of M ranks
(``parallel/tp.py``). Rank 0 alone logs and writes ``{epoch}.save`` (a
split model gathered into the one-process layout, so a run of any size, or
the JAX package, resumes it); the others wait for it.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from bilinear_tpu_torch.config import BilinearConfig, parse_config
from bilinear_tpu_torch.data.h36m import Task, load_h36m
from bilinear_tpu_torch.device import disable_tf32
from bilinear_tpu_torch.io.checkpoint import prune_checkpoints, \
    resume_or_init, save_checkpoint
from bilinear_tpu_torch.io.logger import get_logger
from bilinear_tpu_torch.io.tensorboard import TBWriter
from bilinear_tpu_torch.parallel.mesh import backend, is_primary, \
    shutdown_distributed, start_run
from bilinear_tpu_torch.train.bilinear import BilinearTrainer
from bilinear_tpu_torch.utils.debug import debug_mode
from bilinear_tpu_torch.utils.preempt import GracefulShutdown, \
    global_requested
from bilinear_tpu_torch.utils.profiling import trace

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None) -> None:
    disable_tf32()
    cfg = parse_config(BilinearConfig(), argv)
    mesh, device = start_run(cfg, model=cfg.model_parallel)
    primary = is_primary(mesh)
    logger, log_dir, _ = get_logger(cfg.comment, cfg.save_root,
                                    quiet=not primary)
    parameter_dir = os.path.join(log_dir, "parameter")

    logger.info("=" * 59)
    logger.info("Architecture   : Bilinear (PyTorch/CUDA port)")
    logger.info("   -protocol   : %s", cfg.protocol)
    logger.info("   -device     : %s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else device)
    logger.info("Data           : Human3.6M @ %s", cfg.data_dir)
    logger.info("   -mini batch : %d", cfg.batch_size)
    if mesh is not None:
        logger.info("   -ranks      : %d (data %d x model %d), backend %s",
                    mesh.world, mesh.data, mesh.model, backend())
    logger.info("=" * 59)

    train = load_h36m(cfg.data_dir, cfg.protocol)[Task.Train]
    x, y = (torch.from_numpy(a).to(device) for a in (train.part, train.s))
    trainer = BilinearTrainer(batch_size=cfg.batch_size,
                              dtype=DTYPES[cfg.dtype], device=device,
                              mesh=mesh)
    state, start_epoch = resume_or_init(trainer.init_state(cfg.seed),
                                        parameter_dir)
    if start_epoch:
        logger.info("Resumed from epoch %d (step %d)", start_epoch,
                    state.step)

    writer = TBWriter(log_dir, enabled=primary)
    shutdown = GracefulShutdown(logger)
    epochs_done = 0
    preempted = False
    t_epoch = time.perf_counter()

    def on_epoch_end(epoch: int, st, losses) -> bool:
        nonlocal epochs_done, t_epoch, preempted
        epochs_done += 1
        loss_arr = losses.float().cpu().numpy()  # waits for the epoch
        secs = time.perf_counter() - t_epoch
        trees = st.trees()  # every rank: a split model gathers
        if primary:
            save_checkpoint(parameter_dir, epoch, *trees, step=st.step)
            prune_checkpoints(parameter_dir, cfg.keep_checkpoints,
                              cfg.keep_every)
        if mesh is not None:
            mesh.barrier()
        # Per-step scalars (train_bilinear.py:86), one fetch per epoch; the
        # step counter is past this epoch's last step.
        first_step = st.step - len(loss_arr)
        for i, loss in enumerate(loss_arr):
            writer.scalar("BI/loss", float(loss), first_step + i)
        logger.info("Epoch %d saved (loss: %f, %d steps in %.4f s)", epoch,
                    float(loss_arr[-1]), len(loss_arr), secs)
        t_epoch = time.perf_counter()
        # Truthy stops after this epoch; the ranks agree on it first, or
        # the ones not signalled would wait in the next epoch's
        # collectives.
        shutdown.log_pending()
        preempted = global_requested(shutdown.requested)
        return preempted

    t0 = time.time()
    profile_ctx = trace(log_dir) if cfg.profile and primary \
        else contextlib.nullcontext()
    nan_ctx = debug_mode(state.model) if cfg.debug_nans \
        else contextlib.nullcontext()
    with profile_ctx, nan_ctx, shutdown:
        trainer.fit(state, x, y, epochs=cfg.epochs_per_run,
                    seed=cfg.seed + 1, start_epoch=start_epoch,
                    on_epoch_end=on_epoch_end)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dt = time.time() - t0
    logger.info("%d epochs in %.1fs (%.0f poses/sec)", epochs_done, dt,
                epochs_done * len(train) / dt)
    if preempted:
        logger.info("Preempted after epoch %d/%d; checkpoint saved, exiting "
                    "0", start_epoch + epochs_done,
                    start_epoch + cfg.epochs_per_run)
    writer.close()
    if mesh is not None:
        shutdown_distributed()


if __name__ == "__main__":
    main()
