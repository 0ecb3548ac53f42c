"""PCKh of the fine-tuned hourglass on the H36M valid split (counterpart of
``bilinear_tpu/cli/valid_hourglass_ft.py``, the working rebuild of the
reference's valid_hourglass_FT.py), on the GPU: BN recalibration over the
un-augmented H36M train frames, then flip-TTA argmax PCKh@0.5 over the
valid frames (the JAX CLI calls the flip-TTA ``evaluate_pckh``, whatever its
docstring says, and so does this one).

Usage: python -m bilinear_tpu_torch.cli.valid_hourglass_ft [--data-dir
       data/Human3.6M --comment "Hourglass FT" --batch-size 8]

H36M has no head rectangle: the PCKh length is the proxy
``max(0.6 * |Head - Thorax|, 1e-3)`` of the GT keypoints in MPII order.
Loads the newest checkpoint of ``{save_root}/{comment}/parameter`` and
writes ``pckh_ft_epoch{epoch}.json`` beside it (per-joint PCKh, the
average, per-joint hits and totals). The model runs in f32, as the JAX
CLI's does; ``--device cpu`` runs the plain PyTorch path and is meant for
tests only.
"""
from __future__ import annotations

import json
import os

import numpy as np

from bilinear_tpu_torch.cli.valid_hourglass import eval_trainer
from bilinear_tpu_torch.config import HourglassFTConfig, parse_config
from bilinear_tpu_torch.data.h36m import Task, load_h36m
from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
from bilinear_tpu_torch.data.mpii import MPIIRecord
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.device import disable_tf32, resolve_device
from bilinear_tpu_torch.eval.pckh import pckh_scores, pckh_totals
from bilinear_tpu_torch.eval.recalibrate import recalibrate
from bilinear_tpu_torch.io.checkpoint import resume_or_init
from bilinear_tpu_torch.io.logger import get_logger
from bilinear_tpu_torch.ops.joints import FROM_H36M_TO_MPII

HEAD_JOINT, THORAX_JOINT = 9, 8  # MPII order


class FTRecords(H36MImageRecords):
    """H36M records with MPII-ordered keypoints and the head proxy."""

    def record(self, index: int) -> MPIIRecord:
        rec = super().record(index)
        remap = np.asarray(FROM_H36M_TO_MPII)
        rec.keypoints = rec.keypoints[remap]
        rec.valid = rec.valid[remap]
        head = 0.6 * float(np.linalg.norm(rec.keypoints[HEAD_JOINT]
                                          - rec.keypoints[THORAX_JOINT]))
        rec.head = max(head, 1e-3)
        return rec


def main(argv=None) -> None:
    disable_tf32()
    cfg = parse_config(HourglassFTConfig(), argv)
    device = resolve_device(cfg.device or None)
    logger, log_dir, _ = get_logger(cfg.comment, cfg.save_root)
    parameter_dir = os.path.join(log_dir, "parameter")

    state, epoch = resume_or_init(eval_trainer(cfg, device)
                                  .init_state(cfg.seed), parameter_dir)
    logger.info("Evaluating FT epoch %d (variant %s)", epoch, cfg.variant)

    splits = load_h36m(cfg.data_dir, "GT")

    def pipeline(task):
        return MPIIHostPipeline(FTRecords(splits[task], cfg.data_dir),
                                cfg.batch_size, pad=True, canvas=cfg.canvas,
                                transport=cfg.transport)

    recalibrate(state.model, pipeline(Task.Train))
    hit, total = pckh_totals(state.model, pipeline(Task.Valid))
    per_joint, avg = pckh_scores(hit, total)

    logger.info("=" * 59)
    for joint, pckh in per_joint.items():
        logger.info("%s: %f", joint, pckh)
    logger.info("avg: %f", avg)
    logger.info("=" * 59)
    with open(os.path.join(log_dir, f"pckh_ft_epoch{epoch}.json"), "w") as f:
        json.dump({"epoch": epoch, "avg": avg, "per_joint": per_joint,
                   "hits": hit.tolist(), "totals": total.tolist()}, f)


if __name__ == "__main__":
    main()
