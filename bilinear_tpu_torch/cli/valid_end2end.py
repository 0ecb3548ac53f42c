"""MPJPE of the jointly trained End2End model (counterpart of
``bilinear_tpu/cli/valid_end2end.py``), on the GPU.

Usage: python -m bilinear_tpu_torch.cli.valid_end2end [--data-dir
       data/Human3.6M --variant torch7 --fused-blocks true]

Frames of the H36M GT valid split -> crop with the canvas-space box ->
End2End eval forward, decoding with the original-space box -> normalized 3D
-> un-normalized with the TRAIN split's statistics -> per-sample sum over
the 16 joints of the Euclidean distance to the ground truth, merged per
action (the reference's MPJPE protocol, valid_bilinear.py:51-83), over the
real slots of each batch only (the last batch is zero-padded). The batches
are prepared as ``train_end2end`` prepares them, with no augmentation, and
the model runs in eval mode (running BN statistics, no dropout).

Evaluates the newest checkpoint of ``{save_root}/{comment}/parameter``
(comment "End2End" by default) and writes ``mpjpe_e2e_epoch{N}.json``
beside it. With no checkpoint it stops with an error: the JAX CLI scores a
fresh initialisation as epoch 0 instead. Size flags and ``--fused-blocks``
as for ``train_end2end``; the model runs in ``--dtype`` (f32 by default).
``--device cpu`` runs the plain PyTorch path and is meant for tests only.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from bilinear_tpu_torch.cli.train_end2end import DTYPES, e2e_config
from bilinear_tpu_torch.data.h36m import NUM_JOINTS, Task, load_h36m
from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.device import disable_tf32, resolve_device
from bilinear_tpu_torch.io.checkpoint import latest_epoch, load_checkpoint
from bilinear_tpu_torch.io.logger import get_logger
from bilinear_tpu_torch.ops.affine import crop_batch
from bilinear_tpu_torch.train.end2end import End2EndTrainer
from bilinear_tpu_torch.train.hourglass import batch_tensors


def main(argv=None) -> None:
    disable_tf32()
    cfg, variant, model_kw = e2e_config(argv)
    device = resolve_device(cfg.device or None)
    logger, log_dir, _ = get_logger(cfg.comment, cfg.save_root)
    parameter_dir = os.path.join(log_dir, "parameter")
    epoch = latest_epoch(parameter_dir)
    if epoch <= 0:
        raise SystemExit(f"no checkpoint under {parameter_dir!r}: nothing "
                         "to evaluate (train_end2end writes one)")

    splits = load_h36m(cfg.data_dir, "GT")
    train, valid = splits[Task.Train], splits[Task.Valid]
    pipeline = MPIIHostPipeline(
        H36MImageRecords(valid, cfg.data_dir), cfg.batch_size,
        canvas=cfg.canvas, pad=True, transport=cfg.transport,
        cache_dir=os.path.join(cfg.data_dir, "canvas_cache", "e2e_valid")
        if cfg.cache_canvases and cfg.transport == "u8" else None)
    trainer = End2EndTrainer(variant=variant, batch_size=cfg.batch_size,
                             dtype=DTYPES[cfg.dtype], model_kw=model_kw,
                             device=device)
    model = trainer.make_model(cfg.seed).eval()
    model.load_jax(load_checkpoint(parameter_dir, epoch)["state"])
    logger.info("Evaluating End2End[%s] epoch %d", variant, epoch)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mean_part, std_part = dev(train.mean_part), dev(train.std_part)
    orig_centers = np.asarray(valid.centers, np.float32)
    orig_scales = np.asarray(valid.scales, np.float32)
    n_actions = len(valid.action_names)
    dist_sum = np.zeros(n_actions, np.float64)
    count = np.zeros(n_actions, np.int64)
    for batch in pipeline.epoch(0):
        b = batch_tensors(batch, device)
        safe = np.maximum(batch.index, 0)  # pad slots -> any real record
        with torch.no_grad():
            crops = crop_batch(b["images"], b["centers"], b["scales"],
                               torch.zeros_like(b["scales"]), res=256)
            _, _, pose3d = model(crops, dev(orig_centers[safe]),
                                 dev(orig_scales[safe]), mean_part, std_part)
        pred_mm = pose3d.float().cpu().numpy() * valid.std_s + valid.mean_s
        for slot, i in enumerate(np.asarray(batch.index)):
            if i < 0:
                continue  # zero-padded slot
            gt = valid.raw_s[i].reshape(NUM_JOINTS, 3)
            pr = pred_mm[slot].reshape(NUM_JOINTS, 3)
            a = int(valid.actions[i])
            dist_sum[a] += float(np.linalg.norm(pr - gt, axis=1).sum())
            count[a] += 1

    names = valid.action_names
    per_action = {names[a]: float(dist_sum[a] / (count[a] * NUM_JOINTS))
                  for a in range(n_actions) if count[a]}
    overall = float(dist_sum.sum() / (count.sum() * NUM_JOINTS))
    logger.info("=" * 59)
    for action, mpjpe in per_action.items():
        logger.info("%s: %f", action, mpjpe)
    logger.info("avg: %f", overall)
    logger.info("=" * 59)
    with open(os.path.join(log_dir, f"mpjpe_e2e_epoch{epoch}.json"),
              "w") as f:
        json.dump({"epoch": epoch, "overall": overall,
                   "per_action": per_action}, f)


if __name__ == "__main__":
    main()
