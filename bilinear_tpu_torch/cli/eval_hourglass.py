"""Official MPII test-set inference (counterpart of
``bilinear_tpu/cli/eval_hourglass.py``; the reference's eval_hourglass.py),
on the GPU.

Usage: python -m bilinear_tpu_torch.cli.eval_hourglass [--data-dir
       data/MPII --comment Hourglass --fused-blocks true --train-subset]

Flow (eval_hourglass.py:19-57,128-161): load the newest checkpoint; unless
training is finalized, recalibrate the BN statistics over the train split
once and save them as the ``-1.save`` sentinel, which later runs reuse;
then write one ``{img_idx}.{r_idx}.txt`` prediction per official test rect
(``--train-subset``: the train/valid images instead) under
``{save_root}/{comment}/prediction`` and convert them into
``pred_keypoints_mpii.mat`` for the MPII evaluation kit. The model runs in
f32, as the JAX CLI's does; ``--device cpu`` runs the plain PyTorch path
and is meant for tests only.
"""
from __future__ import annotations

import argparse
import os

from bilinear_tpu_torch.cli.valid_hourglass import eval_pipeline, \
    eval_trainer
from bilinear_tpu_torch.config import HourglassConfig, parse_config
from bilinear_tpu_torch.data.h36m import Task
from bilinear_tpu_torch.data.mpii import MPIITestAnnotations
from bilinear_tpu_torch.device import disable_tf32, resolve_device
from bilinear_tpu_torch.eval.mpii_test_export import convert_predictions, \
    export_predictions
from bilinear_tpu_torch.eval.recalibrate import recalibrate
from bilinear_tpu_torch.io.checkpoint import FINALIZED_EPOCH, is_finalized, \
    load_checkpoint, mark_finalized, resume_or_init
from bilinear_tpu_torch.io.logger import get_logger


def main(argv=None) -> None:
    disable_tf32()
    cfg = parse_config(HourglassConfig(), argv)
    extra = argparse.ArgumentParser()
    # eval_hourglass.py:131 exposes eval_on_training_and_valid_subset.
    extra.add_argument("--train-subset", action="store_true",
                       help="export predictions for the train/valid images "
                            "instead of the official test set")
    opts, _ = extra.parse_known_args(argv)
    device = resolve_device(cfg.device or None)
    logger, log_dir, _ = get_logger(cfg.comment, cfg.save_root)
    parameter_dir = os.path.join(log_dir, "parameter")
    prediction_dir = os.path.join(log_dir, "prediction")

    trainer = eval_trainer(cfg, device)
    state, epoch = resume_or_init(trainer.init_state(cfg.seed),
                                  parameter_dir)
    if is_finalized(parameter_dir):
        logger.info("Using finalized BN statistics (-1.save)")
        state.restore(load_checkpoint(parameter_dir, FINALIZED_EPOCH))
    else:
        logger.info("Finalizing BN statistics over the train split "
                    "(one-time)")
        recalibrate(state.model, eval_pipeline(cfg, Task.Train))
        mark_finalized(parameter_dir, *state.trees(), step=state.step)

    annotations = MPIITestAnnotations(cfg.data_dir,
                                      train_subset=opts.train_subset)
    logger.info("Exporting %d test rects", len(annotations))
    n = export_predictions(state.model, annotations, prediction_dir,
                           batch_size=cfg.batch_size)
    logger.info("Wrote %d prediction files to %s", n, prediction_dir)

    out_mat = os.path.join(log_dir, "pred_keypoints_mpii.mat")
    injected = convert_predictions(cfg.data_dir, prediction_dir, out_mat)
    logger.info("Converter injected %d rects -> %s", injected, out_mat)


if __name__ == "__main__":
    main()
