"""Joint training of hourglass + lifting (counterpart of
``bilinear_tpu/train/end2end.py``):

    canvas batch -> scale jitter (no rotation, no flip) -> crop -> colour
    jitter -> Gaussian heatmaps of the H36M keypoints, channels reordered
    H36M -> MPII -> End2End forward (train mode) -> sum over stacks of the
    per-stack heatmap MSE + lambda_3d * MSE(normalized 3D, s_norm) ->
    clip(1.0) -> RMSprop(2.5e-4) over ALL parameters

The 3D loss reaches the detector through the soft-argmax. The fused decode
maps heatmap to image space with centre and scale, which a rotation would
invalidate, and the reference never flips H36M: so the geometry is the
scale jitter alone, and its factor multiplies both boxes.

Two boxes per sample. The crop uses the canvas-space box (``centers``,
``scales``); the decode uses the SAME box in the original image space
(``decode_centers``, ``decode_scales``), the space of the lifting
statistics: decoding with the canvas box measured 488 mm against 44 mm of
fused MPJPE in the JAX package.

Each step draws three independent streams (JAX splits one key three ways):
the geometry and the colour jitter from CPU generators, the dropout masks
from a generator on the model's device, all seeded from (seed, epoch,
step) and the stream's name (``sample_augment``). With
``model_kw={"fused": True}`` and the torch7 detector, its 107 ResModules
run through kernels K3/K4 on the card.

``mesh=`` trains data-parallel under the detector trainer's rules
(``train/hourglass.py``): global-batch draws sliced to the rank's rows,
global BN statistics in both halves, the lifter's dropout masks drawn for
the global batch, the loss weighted by the global count, gradients summed
over the ranks; fused blocks span the data group through the staged
K3/K4.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bilinear_tpu_torch.core.norm import DataShard, set_data_shard
from bilinear_tpu_torch.core.optim import hourglass_optimizer
from bilinear_tpu_torch.device import resolve_device
from bilinear_tpu_torch.models.detectors import check_trainable
from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.ops import augment as aug
from bilinear_tpu_torch.ops.joints import FROM_H36M_TO_MPII
from bilinear_tpu_torch.parallel.mesh import all_reduce_grads, local_rows
from bilinear_tpu_torch.train import hourglass as th
from bilinear_tpu_torch.train.hourglass import TrainState
from bilinear_tpu_torch.utils.profiling import span


class E2EAugment(NamedTuple):
    """One step's draws: scale jitter, colour jitter, dropout masks."""

    geometry: aug.AugmentParams
    jitter: aug.JitterParams
    dropout: Optional[torch.Generator]


def sample_augment(seed: int, epoch: int, step: int, batch: int,
                   device=None) -> E2EAugment:
    """The three streams of step ``step`` of ``epoch``; the dropout
    generator on ``device`` (the model's)."""
    geo = aug.sample_geometry(th.step_generator(seed, epoch, step,
                                                "geometry"), batch,
                              rotate_prob=0.0, flip_prob=0.0)
    jit = aug.sample_color_jitter(th.step_generator(seed, epoch, step,
                                                    "jitter"), batch)
    return E2EAugment(geo, jit, th.step_generator(seed, epoch, step,
                                                  "dropout", device))


def e2e_loss(heatmaps, pose_3d, targets, s_norm, lambda_3d: float,
             total=None):
    """(loss, heatmap loss, 3D loss): the sum over stacks of the per-stack
    heatmap MSE plus ``lambda_3d`` times the MSE of the normalized 3D
    pose. ``total``: the global batch's rows these are a block of."""
    hm_loss = th.heatmap_loss(heatmaps, targets, total)
    sq = (pose_3d - s_norm).square()
    loss_3d = sq.mean() if total is None else \
        sq.sum() / (total * pose_3d.shape[1])
    return hm_loss + lambda_3d * loss_3d, hm_loss, loss_3d


class End2EndTrainer:
    def __init__(self, variant: str = "torch7", batch_size: int = 8,
                 learning_rate: float = 2.5e-4, lambda_3d: float = 1.0,
                 mesh=None, dtype=torch.float32,
                 model_kw: Optional[dict] = None, device=None):
        """``model_kw``: End2End's detector overrides (``n_stacks``,
        ``features``, ``depth``, ``n_modules``, ``fused``). ``device``:
        None is the card, and raises when there is none. A detector that
        is not ``trainable`` (HRNet, which the port serves) raises."""
        check_trainable(variant)
        self.mesh = th.check_mesh(mesh)
        self.shard = None if self.mesh is None else \
            DataShard(self.mesh.data_group)
        self.variant = variant
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.lambda_3d = lambda_3d
        self.dtype = dtype
        self.model_kw = dict(model_kw or {})
        self.device = resolve_device(device)
        self.remap = torch.as_tensor(np.asarray(FROM_H36M_TO_MPII),
                                     dtype=torch.long, device=self.device)

    def make_model(self, seed: int = 0) -> End2End:
        model = End2End(variant=self.variant, dtype=self.dtype,
                        generator=torch.Generator().manual_seed(seed),
                        **self.model_kw).to(self.device)
        set_data_shard(model, self.shard)
        return model

    def init_state(self, seed: int = 0) -> TrainState:
        model = self.make_model(seed).train()
        return TrainState(model, hourglass_optimizer(model.parameters(),
                                                     self.learning_rate))

    def batch_tensors(self, batch, s_norm, decode_centers, decode_scales
                      ) -> dict:
        """A CanvasBatch's arrays and the rows of the split's normalized 3D
        poses and original-space boxes that its ``index`` names, as tensors
        on the trainer's device (pad slots, index -1, take row 0)."""
        d = th.batch_tensors(batch, self.device)
        idx = np.maximum(np.asarray(batch.index), 0)

        def rows(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a, np.float32)[idx])).to(self.device)

        d.update(s_norm=rows(s_norm), decode_centers=rows(decode_centers),
                 decode_scales=rows(decode_scales))
        return d

    def train_step(self, state: TrainState, batch: dict, stats,
                   augment: E2EAugment):
        """One update. ``batch``: images, centers, scales, keypoints (H36M-16
        order), valid, s_norm, decode_centers, decode_scales; ``stats``:
        (mean_part, std_part) on the device. Returns (loss, heatmap loss,
        3D loss) as device scalars (not synced). Under a mesh every rank
        passes the global batch and draws; the losses are the global
        ones. Its four phases are the spans ``th.STEP_RANGES``, as the
        detector trainer's."""
        preprocess, forward, backward, optimizer = th.STEP_RANGES
        mean_part, std_part = stats
        total = None
        if self.mesh is not None:
            total = batch["images"].shape[0]
            self.shard.place(self.mesh.rows(total)[0], total)
            batch, augment = local_rows(self.mesh, (batch, augment))
        with span(preprocess):
            factor = augment.geometry.scale_factor.to(self.device)
            crops, targets, _ = th.preprocess_batch(
                batch["images"], batch["centers"], batch["scales"],
                batch["keypoints"], batch["valid"],
                th.Augment(augment.geometry, augment.jitter))
            targets = targets[:, self.remap]
        with span(forward):
            state.model.train()
            heatmaps, _, pose_3d = state.model(
                crops, batch["decode_centers"],
                batch["decode_scales"] * factor, mean_part, std_part,
                augment.dropout)
            loss, hm_loss, loss_3d = e2e_loss(heatmaps, pose_3d, targets,
                                              batch["s_norm"],
                                              self.lambda_3d, total)
        with span(backward):
            state.optimizer.zero_grad()
            loss.backward()
            if self.mesh is not None:
                all_reduce_grads(state.model.parameters(),
                                 self.mesh.data_group)
        with span(optimizer):
            state.optimizer.step()
        state.step += 1
        return tuple(th.global_loss(v, self.mesh)
                     for v in (loss, hm_loss, loss_3d))
