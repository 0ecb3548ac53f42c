"""Fine-tune the pre-activation hourglass on H36M (counterpart of
``bilinear_tpu/cli/train_hourglass_ft.py``; the reference's
train_hourglass_FT.py entry point), on the GPU.

Usage: python -m bilinear_tpu_torch.cli.train_hourglass_ft [--data-dir
       data/Human3.6M --batch-size 8 --epochs-per-run 100 --dtype bfloat16]

Trains ``StackedHourglass`` (``--variant preact``, the default of
``HourglassFTConfig``) on the H36M GT train frames: scale and rotation
augmentation and colour jitter, never a flip; the target heatmaps'
channels reordered H36M -> MPII (``FROM_H36M_TO_MPII``); sum-of-stacks
MSE, clip 1.0, RMSprop 2.5e-4, 100 epochs per invocation. Writes
``{save_root}/{comment}/parameter/{epoch}.save`` (the JAX package's layout,
so either package resumes it), prunes, resumes from the newest epoch, and
writes ``FT/loss`` scalars and ``debug.log``. ``--device cpu`` runs the
plain PyTorch path and is meant for tests only. ``--debug-nans`` checks
every module's output and every backward node (``utils/debug.py``);
``--cache-canvases`` decodes each frame once into
``{data_dir}/canvas_cache/ft_train``; SIGTERM or SIGINT finishes the
epoch, checkpoints it and exits 0 (``utils/preempt.py``). ``--coordinator host:port
--num-processes N --process-id i`` trains data-parallel over N processes,
as ``train_hourglass`` does (rank 0 alone logs and saves).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from bilinear_tpu_torch.config import HourglassFTConfig, parse_config
from bilinear_tpu_torch.data.h36m import Task, load_h36m
from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.device import disable_tf32
from bilinear_tpu_torch.io.checkpoint import prune_checkpoints, \
    resume_or_init, save_checkpoint
from bilinear_tpu_torch.io.logger import get_logger
from bilinear_tpu_torch.io.tensorboard import TBWriter
from bilinear_tpu_torch.parallel.mesh import backend, is_primary, \
    shutdown_distributed, start_run
from bilinear_tpu_torch.ops.joints import FROM_H36M_TO_MPII
from bilinear_tpu_torch.train.hourglass import HourglassTrainer
from bilinear_tpu_torch.utils.debug import debug_mode
from bilinear_tpu_torch.utils.preempt import GracefulShutdown, \
    global_requested

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None) -> None:
    disable_tf32()
    cfg = parse_config(HourglassFTConfig(), argv)
    mesh, device = start_run(cfg)
    primary = is_primary(mesh)
    logger, log_dir, _ = get_logger(cfg.comment, cfg.save_root,
                                          quiet=not primary)
    if mesh is not None:
        logger.info("ranks: %d, backend %s", mesh.world, backend())
    parameter_dir = os.path.join(log_dir, "parameter")
    logger.info("Fine-tuning hourglass[%s] on H36M heatmaps @ %s (%s)",
                cfg.variant, cfg.data_dir,
                torch.cuda.get_device_name(device)
                if device.type == "cuda" else device)

    records = H36MImageRecords(load_h36m(cfg.data_dir, "GT")[Task.Train],
                               cfg.data_dir)
    pipeline = MPIIHostPipeline(
        records, cfg.batch_size, canvas=cfg.canvas, shuffle=True,
        seed=cfg.seed, transport=cfg.transport,
        cache_dir=os.path.join(cfg.data_dir, "canvas_cache", "ft_train")
        if cfg.cache_canvases else None)
    trainer = HourglassTrainer(
        variant=cfg.variant, learning_rate=cfg.learning_rate,
        dtype=DTYPES[cfg.dtype], n_stacks=cfg.n_stacks, features=cfg.features,
        depth=cfg.depth, n_modules=cfg.n_modules,
        fused_blocks=cfg.fused_blocks, device=device, mesh=mesh,
        joint_remap=FROM_H36M_TO_MPII, flip_prob=0.0)
    state, start_epoch = resume_or_init(trainer.init_state(cfg.seed),
                                        parameter_dir)
    if start_epoch:
        logger.info("Resumed from epoch %d (step %d)", start_epoch,
                    state.step)

    writer = TBWriter(log_dir, enabled=primary)
    shutdown = GracefulShutdown(logger)
    with shutdown:
        for epoch in range(start_epoch + 1,
                           start_epoch + cfg.epochs_per_run + 1):
            t0 = time.perf_counter()
            with debug_mode(state.model) if cfg.debug_nans else \
                    contextlib.nullcontext():
                state, loss = trainer.fit_epoch(
                    state, pipeline, epoch, cfg.seed + 1, log_every=100,
                    logger=logger, group=cfg.steps_per_dispatch)
                loss = float(loss)  # waits for the epoch's work
            img_s = len(records) / (time.perf_counter() - t0)
            if primary:
                save_checkpoint(parameter_dir, epoch, *state.trees(),
                                step=state.step)
                prune_checkpoints(parameter_dir, cfg.keep_checkpoints,
                                  cfg.keep_every)
            if mesh is not None:
                mesh.barrier()
            writer.scalar("FT/loss", loss, state.step)
            logger.info("Epoch %d saved (loss: %f, epoch %.1f img/s)",
                        epoch, loss, img_s)
            shutdown.log_pending()
            if global_requested(shutdown.requested):
                logger.info("Preempted after epoch %d; checkpoint saved, "
                            "exiting 0", epoch)
                break
    writer.close()
    if mesh is not None:
        shutdown_distributed()


if __name__ == "__main__":
    main()
