"""Train the stacked-hourglass detector on MPII (counterpart of
``bilinear_tpu/cli/train_hourglass.py``; the reference's train_hourglass.py
entry point), on the GPU.

Usage: python -m bilinear_tpu_torch.cli.train_hourglass [--data-dir
       data/MPII --batch-size 8 --epochs-per-run 10 --dtype bfloat16
       --fused-blocks true ...]

Writes ``{save_root}/{comment}/parameter/{epoch}.save`` (the JAX package's
payload layout, so either package resumes it), resumes from the newest
epoch, logs to ``debug.log`` beside it, and after each epoch runs an
eval-mode forward of one batch for the TensorBoard heatmap overlays. The
trainer runs on the card; ``--device cpu`` runs the plain PyTorch path and
is meant for tests only.

Multi-process data parallelism: ``--coordinator host:port --num-processes
N --process-id i`` on every process, and ``--local-processes L`` when the
ranks span hosts, numbered host by host (rank i on ``cuda:{(i % L) %
cards}`` unless ``--device``; ``nccl`` when each rank of a host has a
card of its own, ``gloo`` otherwise: ``parallel/mesh.py::rank_layout``).
Every rank reads the same batches and trains on its rows of
each (global BN statistics); rank 0 alone logs, draws the overlays and
writes ``{epoch}.save``, and the others wait for it. ``--fused-blocks
true`` with more than one rank raises (``train/hourglass.py``).
"""
from __future__ import annotations

import os
import time

import torch

from bilinear_tpu_torch.config import HourglassConfig, parse_config
from bilinear_tpu_torch.data.h36m import Task
from bilinear_tpu_torch.data.mpii import MPIIAnnotations
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.device import disable_tf32
from bilinear_tpu_torch.io.checkpoint import prune_checkpoints, \
    resume_or_init, save_checkpoint
from bilinear_tpu_torch.io.logger import get_logger
from bilinear_tpu_torch.io.tensorboard import TBWriter
from bilinear_tpu_torch.parallel.mesh import backend, is_primary, \
    shutdown_distributed, start_run
from bilinear_tpu_torch.io.visualize import heatmap_overlay
from bilinear_tpu_torch.train.hourglass import HourglassTrainer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None) -> None:
    disable_tf32()
    cfg = parse_config(HourglassConfig(), argv)
    if cfg.debug_nans:
        raise NotImplementedError("--debug-nans is not ported yet")
    mesh, device = start_run(cfg)
    primary = is_primary(mesh)
    logger, log_dir, comment = get_logger(cfg.comment, cfg.save_root,
                                          quiet=not primary)
    if mesh is not None:
        logger.info("ranks: %d, backend %s", mesh.world, backend())
    parameter_dir = os.path.join(log_dir, "parameter")

    logger.info("=" * 59)
    logger.info("Architecture   : StackedHourglass[%s] (PyTorch/CUDA port, "
                "fused blocks %s)", cfg.variant, cfg.fused_blocks)
    logger.info("   -device     : %s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else device)
    logger.info("Data           : MPII @ %s", cfg.data_dir)
    logger.info("   -mini batch : %d", cfg.batch_size)
    logger.info("=" * 59)

    annotations = MPIIAnnotations(cfg.data_dir, Task.Train)
    pipeline = MPIIHostPipeline(
        annotations, cfg.batch_size, canvas=cfg.canvas, shuffle=True,
        seed=cfg.seed, transport=cfg.transport,
        cache_dir=os.path.join(cfg.data_dir, "canvas_cache", "train")
        if cfg.cache_canvases else None,
    )
    trainer = HourglassTrainer(
        variant=cfg.variant, learning_rate=cfg.learning_rate,
        dtype=DTYPES[cfg.dtype], n_stacks=cfg.n_stacks, features=cfg.features,
        depth=cfg.depth, n_modules=cfg.n_modules,
        fused_blocks=cfg.fused_blocks, device=device, mesh=mesh,
    )
    state, start_epoch = resume_or_init(trainer.init_state(cfg.seed),
                                        parameter_dir)
    if start_epoch:
        logger.info("Resumed from epoch %d (step %d)", start_epoch,
                    state.step)

    writer = TBWriter(log_dir, enabled=primary)
    for epoch in range(start_epoch + 1, start_epoch + cfg.epochs_per_run + 1):
        t0 = time.perf_counter()
        state, loss = trainer.fit_epoch(
            state, pipeline, epoch, cfg.seed + 1, log_every=50,
            logger=logger, group=cfg.steps_per_dispatch)
        loss = float(loss)  # waits for the epoch's work
        img_s = len(annotations) / (time.perf_counter() - t0)

        t0 = time.perf_counter()
        if primary:
            save_checkpoint(parameter_dir, epoch, *state.trees(),
                            step=state.step)
            prune_checkpoints(parameter_dir, cfg.keep_checkpoints,
                              cfg.keep_every)
        t_save = time.perf_counter() - t0
        writer.scalar("HG/loss", loss, state.step)

        # Heatmap-overlay images (the reference's train_hourglass.py:84-89).
        t0 = time.perf_counter()
        if primary:
            batch = trainer.batch_tensors(next(iter(pipeline.epoch(epoch))))
            crops, tgt, pred = trainer.overlay_forward(state, batch)
            writer.image(f"{comment}/train/ground-truth",
                         heatmap_overlay(crops, tgt), state.step)
            writer.image(f"{comment}/train/prediction",
                         heatmap_overlay(crops, pred), state.step)
        if mesh is not None:
            mesh.barrier()
        logger.info("Epoch %d saved (loss: %f, epoch %.1f img/s, ckpt %.1fs, "
                    "tb %.1fs)", epoch, loss, img_s, t_save,
                    time.perf_counter() - t0)
    writer.close()
    if mesh is not None:
        shutdown_distributed()


if __name__ == "__main__":
    main()
