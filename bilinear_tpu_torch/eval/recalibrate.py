"""Eval-time BatchNorm recalibration (counterpart of
``bilinear_tpu/eval/recalibrate.py``; the reference's protocol,
``valid_hourglass.py:23-48``): reset every BN's running statistics, set
every BN to the cumulative average (``momentum=None``), run the model in
train mode under ``no_grad`` over the un-augmented train split, then put
the momenta back.

Padded tail slots of the pipeline's last batch are cut off before the
forward, so only real samples enter the statistics; with the cumulative
average every batch weighs the same, the short last one included. With
``fused=True`` every ResModule runs kernel K3 in train mode with no running
statistics of its own (``running=None``), and
``core.norm.update_running_stats`` applies the cumulative update.
"""
from __future__ import annotations

from typing import Optional

import torch

from bilinear_tpu_torch.core.norm import cumulative_momentum, \
    reset_batch_stats
from bilinear_tpu_torch.train.hourglass import batch_tensors, \
    preprocess_batch


@torch.no_grad()
def recalibrate(model: torch.nn.Module, pipeline,
                max_batches: Optional[int] = None) -> int:
    """Rebuild ``model``'s BN running statistics in place over
    ``pipeline`` (an un-augmented, padded ``MPIIHostPipeline`` of the
    train split), on the model's device. The model's train/eval mode is
    restored afterwards. Returns the number of batches."""
    dev = next(model.parameters()).device
    was_training = model.training
    reset_batch_stats(model)
    n_batches = 0
    with cumulative_momentum(model):
        model.train()
        try:
            for batch in pipeline.epoch(0):
                if max_batches is not None and n_batches >= max_batches:
                    break
                b = batch_tensors(batch, dev,
                                  rows=batch.images.shape[0] - batch.pad)
                crops, _, _ = preprocess_batch(
                    b["images"], b["centers"], b["scales"], b["keypoints"],
                    b["valid"], None)
                model(crops)
                n_batches += 1
        finally:
            model.train(was_training)
    return n_batches
