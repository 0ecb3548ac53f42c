"""Evaluate H36M MPJPE (counterpart of ``bilinear_tpu/cli/valid_bilinear.py``;
the reference's valid_bilinear.py entry point), on the GPU.

Usage: python -m bilinear_tpu_torch.cli.valid_bilinear [--data-dir
       data/Human3.6M --comment "Bilinear GT" ...]

Loads the newest checkpoint from ``{save_root}/{comment}/parameter`` (a
fresh model at epoch 0 when there is none, as the JAX CLI does), runs the
f32 eval-mode ``BilinearUnit`` over the valid split, logs per-action and
average MPJPE in mm (sub-action suffixes merged) and writes
``mpjpe_epoch{epoch}.json`` beside the checkpoints. ``--device cpu`` runs
on the CPU and is meant for tests only.
"""
from __future__ import annotations

import json
import os

from bilinear_tpu_torch.config import BilinearConfig, parse_config
from bilinear_tpu_torch.data.h36m import Task, load_h36m
from bilinear_tpu_torch.device import disable_tf32, resolve_device
from bilinear_tpu_torch.eval.mpjpe import evaluate_mpjpe, make_mpjpe_fn
from bilinear_tpu_torch.io.checkpoint import resume_or_init
from bilinear_tpu_torch.io.logger import get_logger
from bilinear_tpu_torch.train.bilinear import BilinearTrainer


def main(argv=None) -> None:
    disable_tf32()
    cfg = parse_config(BilinearConfig(), argv)
    device = resolve_device(cfg.device or None)
    logger, log_dir, _ = get_logger(cfg.comment, cfg.save_root)
    parameter_dir = os.path.join(log_dir, "parameter")

    valid = load_h36m(cfg.data_dir, cfg.protocol)[Task.Valid]
    trainer = BilinearTrainer(batch_size=cfg.batch_size, device=device)
    state, epoch = resume_or_init(trainer.init_state(cfg.seed),
                                  parameter_dir)
    logger.info("Evaluating epoch %d", epoch)

    per_action, overall = evaluate_mpjpe(make_mpjpe_fn(state.model), valid)

    logger.info("=" * 59)
    for action, mpjpe in per_action.items():
        logger.info("%s: %f", action, mpjpe)
    logger.info("avg: %f", overall)
    logger.info("=" * 59)

    with open(os.path.join(log_dir, f"mpjpe_epoch{epoch}.json"), "w") as f:
        json.dump({"epoch": epoch, "overall": overall,
                   "per_action": per_action}, f)


if __name__ == "__main__":
    main()
