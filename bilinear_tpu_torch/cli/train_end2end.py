"""Joint End2End training (counterpart of
``bilinear_tpu/cli/train_end2end.py``), on the GPU.

Usage: python -m bilinear_tpu_torch.cli.train_end2end [--data-dir
       data/Human3.6M --variant torch7 --fused-blocks true
       --learning-rate 2.5e-5 --lambda-3d 1.0]

Trains ``End2End`` (hourglass -> soft-argmax -> lifting) on the H36M GT
train frames with ``End2EndTrainer``; the config is ``HourglassFTConfig``,
so the detector is the preact variant unless ``--variant torch7``, and the
comment defaults to "End2End". A fresh run warm-starts each half from the
newest checkpoint of ``{save_root}/Hourglass/parameter`` and ``{save_root}/
Bilinear GT/parameter`` when there is one (either package's ``.save``);
warm-starting converged halves needs a low rate (``--learning-rate
2.5e-5``: RMSprop's first updates are ~10 lr sign(g)). Writes
``{save_root}/{comment}/parameter/{epoch}.save`` in the JAX layout (either
package resumes it), prunes, resumes from the newest epoch, and writes the
``E2E/loss``, ``E2E/heatmap`` and ``E2E/3d`` scalars and ``debug.log``.

Unlike the JAX CLI, the config's ``--n-stacks/--features/--depth/
--n-modules`` and ``--fused-blocks`` reach the model (the JAX CLI drops
them). ``--fused-blocks true`` with ``--variant torch7`` runs the
detector's ResModules through kernels K3/K4. ``--device cpu`` runs the
plain PyTorch path and is meant for tests only. ``--debug-nans`` checks
every module's output and every backward node (``utils/debug.py``);
``--cache-canvases`` (with the default ``--transport u8``) decodes each
frame once into ``{data_dir}/canvas_cache/e2e_train``; SIGTERM or SIGINT
finishes the epoch, checkpoints it and exits 0 (``utils/preempt.py``; over
ranks, one signalled rank stops them all after that epoch).

Multi-process data parallelism: ``--coordinator host:port --num-processes
N --process-id i`` on every process, as for ``train_hourglass``: every
rank reads the same batches and draws and trains on its rows (global BN
statistics in both halves); rank 0 alone logs and writes ``{epoch}.save``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from bilinear_tpu_torch.config import HourglassFTConfig, parse_config
from bilinear_tpu_torch.data.h36m import Task, load_h36m
from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.device import disable_tf32
from bilinear_tpu_torch.io.checkpoint import latest_epoch, \
    load_checkpoint, prune_checkpoints, resume_or_init, save_checkpoint
from bilinear_tpu_torch.io.logger import get_logger
from bilinear_tpu_torch.io.tensorboard import TBWriter
from bilinear_tpu_torch.parallel.mesh import backend, is_primary, \
    shutdown_distributed, start_run
from bilinear_tpu_torch.train.end2end import End2EndTrainer, sample_augment
from bilinear_tpu_torch.utils import weights as wt
from bilinear_tpu_torch.utils.debug import debug_mode
from bilinear_tpu_torch.utils.preempt import GracefulShutdown, \
    global_requested

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def e2e_config(argv=None):
    """``HourglassFTConfig`` with the comment "End2End" (unless given) and
    the End2End trainer's keyword arguments from it."""
    cfg = parse_config(HourglassFTConfig(), argv)
    if cfg.comment == "Hourglass FT":
        cfg.comment = "End2End"
    variant = "torch7" if cfg.variant == "torch7" else "preact"
    model_kw = dict(n_stacks=cfg.n_stacks, features=cfg.features,
                    depth=cfg.depth, n_modules=cfg.n_modules,
                    fused=cfg.fused_blocks)
    return cfg, variant, model_kw


def _maybe_warm_start(state, save_root, logger) -> list:
    """Load each half of a fresh End2End from the newest checkpoint of
    ``{save_root}/Hourglass`` and ``{save_root}/Bilinear GT`` that exists.
    A detector checkpoint of the other variant stops the run with both
    names. Returns the halves taken."""
    model = state.model
    taken = []
    for name, run in (("hourglass", "Hourglass"),
                      ("bilinear", "Bilinear GT")):
        pdir = os.path.join(save_root, run, "parameter")
        epoch = latest_epoch(pdir)
        if epoch <= 0:
            continue
        st = load_checkpoint(pdir, epoch)["state"]
        if name == "hourglass":
            found = wt.detector_variant_of_jax(st["params"])
            if found != model.variant:
                raise SystemExit(
                    f"{pdir}/{epoch}.save holds a {found!r} detector; this "
                    f"End2End run trains the {model.variant!r} one "
                    f"(--variant)")
            sd = wt.HOURGLASS[found].from_jax(st["params"], st["batch_stats"])
        else:
            sd = wt.bilinear_from_jax(st["params"], st["batch_stats"])
        getattr(model, name).load_state_dict(sd)
        taken.append(name)
        logger.info("Warm-started %s from %s (epoch %d)", name, pdir, epoch)
    return taken


def main(argv=None) -> None:
    disable_tf32()
    cfg, variant, model_kw = e2e_config(argv)
    extra = argparse.ArgumentParser()
    extra.add_argument("--lambda-3d", type=float, default=1.0)
    args, _ = extra.parse_known_args(argv)
    mesh, device = start_run(cfg)
    primary = is_primary(mesh)
    logger, log_dir, _ = get_logger(cfg.comment, cfg.save_root,
                                    quiet=not primary)
    if mesh is not None:
        logger.info("ranks: %d, backend %s", mesh.world, backend())
    parameter_dir = os.path.join(log_dir, "parameter")

    train = load_h36m(cfg.data_dir, "GT")[Task.Train]
    records = H36MImageRecords(train, cfg.data_dir)
    if len(records) < cfg.batch_size:
        raise SystemExit(
            f"train split has {len(records)} samples < batch size "
            f"{cfg.batch_size}: drop_last would yield zero steps per epoch")
    pipeline = MPIIHostPipeline(
        records, cfg.batch_size, canvas=cfg.canvas, shuffle=True,
        seed=cfg.seed, drop_last=True, transport=cfg.transport,
        cache_dir=os.path.join(cfg.data_dir, "canvas_cache", "e2e_train")
        if cfg.cache_canvases and cfg.transport == "u8" else None)
    trainer = End2EndTrainer(
        variant=variant, batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate, lambda_3d=args.lambda_3d,
        dtype=DTYPES[cfg.dtype], model_kw=model_kw, device=device,
        mesh=mesh)
    state, start_epoch = resume_or_init(trainer.init_state(cfg.seed),
                                        parameter_dir)
    if start_epoch == 0:
        _maybe_warm_start(state, cfg.save_root, logger)
    else:
        logger.info("Resumed from epoch %d (step %d)", start_epoch,
                    state.step)
    logger.info("End2End[%s] joint training @ %s (%s)", variant,
                cfg.data_dir, torch.cuda.get_device_name(device)
                if device.type == "cuda" else device)

    stats = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in (train.mean_part, train.std_part))
    writer = TBWriter(log_dir, enabled=primary)
    shutdown = GracefulShutdown(logger)
    with shutdown:
        for epoch in range(start_epoch + 1,
                           start_epoch + cfg.epochs_per_run + 1):
            _epoch(cfg, epoch, trainer, state, pipeline, train, stats, mesh,
                   primary, parameter_dir, writer, logger, device)
            shutdown.log_pending()
            if global_requested(shutdown.requested):
                logger.info("Preempted after epoch %d; checkpoint saved, "
                            "exiting 0", epoch)
                break
    writer.close()
    if mesh is not None:
        shutdown_distributed()


def _epoch(cfg, epoch, trainer, state, pipeline, train, stats, mesh,
           primary, parameter_dir, writer, logger, device) -> None:
    """One epoch: train (under ``--debug-nans``'s checks when asked),
    checkpoint, log."""
    t0 = time.perf_counter()
    n = 0
    with debug_mode(state.model) if cfg.debug_nans else \
            contextlib.nullcontext():
        for batch in pipeline.epoch(epoch):
            b = trainer.batch_tensors(batch, train.s, train.centers,
                                      train.scales)
            augment = sample_augment(cfg.seed + 1, epoch, state.step,
                                     b["images"].shape[0], device)
            loss, hm_loss, loss_3d = trainer.train_step(state, b, stats,
                                                        augment)
            n += b["images"].shape[0]
        loss, hm_loss, loss_3d = float(loss), float(hm_loss), float(loss_3d)
    img_s = n / (time.perf_counter() - t0)
    if primary:
        save_checkpoint(parameter_dir, epoch, *state.trees(),
                        step=state.step)
        prune_checkpoints(parameter_dir, cfg.keep_checkpoints,
                          cfg.keep_every)
    if mesh is not None:
        mesh.barrier()
    writer.scalar("E2E/loss", loss, state.step)
    writer.scalar("E2E/heatmap", hm_loss, state.step)
    writer.scalar("E2E/3d", loss_3d, state.step)
    logger.info("Epoch %d saved (loss %f = hm %f + 3d %f, epoch %.1f "
                "img/s)", epoch, loss, hm_loss, loss_3d, img_s)


if __name__ == "__main__":
    main()
