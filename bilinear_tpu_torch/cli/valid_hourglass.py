"""Evaluate MPII PCKh@0.5 (counterpart of
``bilinear_tpu/cli/valid_hourglass.py``; the reference's
valid_hourglass.py entry point), on the GPU: BN recalibration over the
un-augmented train split, then flip-TTA argmax PCKh over the valid split
(valid_hourglass.py:23-142).

Usage: python -m bilinear_tpu_torch.cli.valid_hourglass [--data-dir
       data/MPII --comment Hourglass --batch-size 8 --fused-blocks true ...]

Loads the newest checkpoint from ``{save_root}/{comment}/parameter`` and
writes ``pckh_epoch{epoch}.json`` beside it (per-joint PCKh, the average,
and the per-joint hit and annotated counts). The model runs in f32, as the
JAX CLI's does; ``--fused-blocks true`` routes its ResModules through
kernel K3 (train mode for the recalibration, eval mode for PCKh) and gives
the same function. ``--device cpu`` runs the plain PyTorch path and is
meant for tests only.
"""
from __future__ import annotations

import json
import os

from bilinear_tpu_torch.config import HourglassConfig, parse_config
from bilinear_tpu_torch.data.h36m import Task
from bilinear_tpu_torch.data.mpii import MPIIAnnotations
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.device import disable_tf32, resolve_device
from bilinear_tpu_torch.eval.pckh import pckh_scores, pckh_totals
from bilinear_tpu_torch.eval.recalibrate import recalibrate
from bilinear_tpu_torch.io.checkpoint import resume_or_init
from bilinear_tpu_torch.io.logger import get_logger
from bilinear_tpu_torch.train.hourglass import HourglassTrainer


def eval_trainer(cfg: HourglassConfig, device) -> HourglassTrainer:
    """The detector of an evaluation CLI: the config's size and ResModule
    path, in f32."""
    return HourglassTrainer(
        variant=cfg.variant, n_stacks=cfg.n_stacks, features=cfg.features,
        depth=cfg.depth, n_modules=cfg.n_modules,
        fused_blocks=cfg.fused_blocks, device=device)


def eval_pipeline(cfg: HourglassConfig, task: str) -> MPIIHostPipeline:
    """Padded, un-augmented batches of one split."""
    return MPIIHostPipeline(
        MPIIAnnotations(cfg.data_dir, task), cfg.batch_size, pad=True,
        transport=cfg.transport, canvas=cfg.canvas,
        cache_dir=os.path.join(cfg.data_dir, "canvas_cache", task.lower())
        if cfg.cache_canvases else None)


def main(argv=None) -> None:
    disable_tf32()
    cfg = parse_config(HourglassConfig(), argv)
    device = resolve_device(cfg.device or None)
    logger, log_dir, _ = get_logger(cfg.comment, cfg.save_root)
    parameter_dir = os.path.join(log_dir, "parameter")

    trainer = eval_trainer(cfg, device)
    state, epoch = resume_or_init(trainer.init_state(cfg.seed),
                                  parameter_dir)
    logger.info("Evaluating epoch %d (variant %s, fused blocks %s)", epoch,
                cfg.variant, cfg.fused_blocks)

    # BN recalibration over the un-augmented train split
    # (valid_hourglass.py:23-48).
    recalibrate(state.model, eval_pipeline(cfg, Task.Train))
    hit, total = pckh_totals(state.model, eval_pipeline(cfg, Task.Valid))
    per_joint, avg = pckh_scores(hit, total)

    logger.info("=" * 59)
    for joint, pckh in per_joint.items():
        logger.info("%s: %f", joint, pckh)
    logger.info("avg: %f", avg)
    logger.info("=" * 59)

    with open(os.path.join(log_dir, f"pckh_epoch{epoch}.json"), "w") as f:
        json.dump({"epoch": epoch, "avg": avg, "per_joint": per_joint,
                   "hits": hit.tolist(), "totals": total.tolist()}, f)


if __name__ == "__main__":
    main()
