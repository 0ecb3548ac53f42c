"""The detector's trainer (counterpart of ``bilinear_tpu/train/hourglass.py``):

    canvas batch -> augment draws -> crop + rotate -> flip -> colour jitter
    -> Gaussian heatmaps -> MainModel forward -> sum over stacks of the
    per-stack mean MSE -> clip(1.0) -> RMSprop(2.5e-4)

Everything after the host pipeline runs on the model's device. With
``fused_blocks=True`` the 107 ResModules of the full-width torch7 model
run through kernels K3 (forward) and K4 (backward) on the card. The
pre-activation variant (``variant="preact"``, the H36M fine-tuning's) has
no fused path. Fine-tuning gathers the target channels through
``joint_remap`` (``FROM_H36M_TO_MPII``) and never flips (``flip_prob=0``).

Augmentation (the reference's MPII/data.py:83-138): scale *= 2^rand(0.25);
rotation rand(30) w.p. 0.4; flip w.p. 0.4 with the L/R joint swap, the
keypoints mirrored about the centre and the rotation negated;
ColorJitter(.3, .3, .3, .3); joints out of the heatmap are masked out of
the target. Each step's draws come from a CPU ``torch.Generator`` seeded
from (seed, epoch, step), so a step's augmentation does not depend on the
device.

``mesh=`` (``parallel/mesh.py::make_mesh``) trains data-parallel over
ranks: every rank reads the same batches and augmentation draws (drawn for
the global batch), keeps its row block of both, normalises with the global
batch's BN statistics (``core/norm.py::global_batch_norm``), takes its
share of the global loss, and sums the gradients over the ranks, so a
step is the one-process step. Fused blocks do the same through the staged
K3/K4 (``ops/resmodule.py``: each block's three BN reductions merged over
the data group between the kernels' stages).

``remat=True`` recomputes the stem's and every stack's activations in the
backward (``core/remat.py``; JAX wraps its forward in ``jax.checkpoint``):
the step's numbers are the plain step's, and the running statistics are
updated once.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

import torch.distributed as dist

from bilinear_tpu_torch.core.norm import DataShard, set_data_shard
from bilinear_tpu_torch.core.optim import HourglassOptimizer, \
    hourglass_optimizer
from bilinear_tpu_torch.device import resolve_device
from bilinear_tpu_torch.models import detectors
from bilinear_tpu_torch.ops import augment as aug
from bilinear_tpu_torch.ops.affine import crop_batch, hflip
from bilinear_tpu_torch.ops.heatmap import keypoints_to_heatmap_space, \
    render_heatmaps
from bilinear_tpu_torch.ops.joints import MPII_FLIP_SWAP
from bilinear_tpu_torch.parallel.mesh import all_reduce_grads, local_rows
from bilinear_tpu_torch.utils import weights as wt
from bilinear_tpu_torch.utils.profiling import span

# Spans (utils/profiling.py::span) of HourglassTrainer.train_step and
# End2EndTrainer.train_step, in order: augmentation and targets, forward +
# loss, zero_grad + backward, clip + RMSprop.
STEP_RANGES = ("train_step/preprocess", "train_step/forward",
               "train_step/backward", "train_step/optimizer")


class Augment(NamedTuple):
    geometry: aug.AugmentParams
    jitter: aug.JitterParams


def sample_augment(gen: torch.Generator, batch: int,
                   flip_prob: float = 0.4) -> Augment:
    """One step's augmentation draws (CPU tensors)."""
    return Augment(aug.sample_geometry(gen, batch, flip_prob=flip_prob),
                   aug.sample_color_jitter(gen, batch))


def preprocess_batch(images, centers, scales, keypoints, valid,
                     augment: Optional[Augment], res: int = 256,
                     heatmap_size: int = 64):
    """Crop, augment and render targets on the device of ``images``.
    Returns (crops (B, res, res, 3), target heatmaps (B, J, hm, hm),
    keypoints). ``augment=None`` is the eval path."""
    dev = images.device
    b = images.shape[0]
    if augment is not None:
        g = augment.geometry
        scales = scales * g.scale_factor.to(dev)
        rotate = g.rotate_deg.to(dev)
        flip = g.flip.to(dev)
    else:
        rotate = torch.zeros(b, device=dev)
        flip = torch.zeros(b, dtype=torch.bool, device=dev)

    crops = crop_batch(images, centers, scales, rotate, res=res)
    if augment is not None:
        crops = torch.where(flip[:, None, None, None], hflip(crops), crops)
        mirrored = aug.flip_keypoints_x(keypoints, centers[:, 0:1],
                                        MPII_FLIP_SWAP)
        keypoints = torch.where(flip[:, None, None], mirrored, keypoints)
        swap = torch.as_tensor(MPII_FLIP_SWAP, dtype=torch.long, device=dev)
        valid = torch.where(flip[:, None], valid[:, swap], valid)
        rotate = torch.where(flip, -rotate, rotate)
        j = augment.jitter
        crops = aug.apply_color_jitter(crops, j._replace(
            brightness=j.brightness.to(dev), contrast=j.contrast.to(dev),
            saturation=j.saturation.to(dev), hue=j.hue.to(dev)))
    hm_xy = keypoints_to_heatmap_space(torch.nan_to_num(keypoints), centers,
                                       scales, rotate, size=heatmap_size)
    return crops, render_heatmaps(hm_xy, valid, size=heatmap_size), keypoints


def batch_tensors(batch, device, rows: Optional[int] = None) -> dict:
    """A CanvasBatch's images, centres, scales, keypoints and validity as
    tensors on ``device``; ``rows`` keeps the first rows only."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[:rows])).to(device)

    return dict(images=t(batch.images), centers=t(batch.centers),
                scales=t(batch.scales), keypoints=t(batch.keypoints),
                valid=t(batch.valid))


def heatmap_loss(out: torch.Tensor, targets: torch.Tensor,
                 total: Optional[int] = None) -> torch.Tensor:
    """Sum over stacks of the per-stack mean MSE; out (S, B, H, W, J),
    targets (B, J, H, W). ``total``: the rows of the global batch these
    are a block of (the block's share of the global loss)."""
    tgt = targets.permute(0, 2, 3, 1)
    sq = (out - tgt[None]).square()
    if total is None:
        return sq.mean(dim=(1, 2, 3, 4)).sum()
    return sq.sum(dim=(1, 2, 3, 4)).sum() / (total * out.shape[2:].numel())


def check_mesh(mesh):
    """The mesh a detector trainer takes: None for one rank; the detectors
    have no tensor parallelism."""
    if mesh is None or mesh.world == 1:
        return None
    if mesh.model > 1:
        raise ValueError("the detectors have no tensor parallelism; use a "
                         "mesh with model=1")
    return mesh


def step_generator(seed: int, epoch: int, step: int, stream: str = "",
                   device=None) -> torch.Generator:
    """A generator seeded from (seed, epoch, step) and, for a step that
    draws several independent streams, the stream's name; on the CPU
    unless ``device`` says otherwise."""
    key = f"{seed}:{epoch}:{step}" + (f":{stream}" if stream else "")
    digest = hashlib.sha256(key.encode()).digest()
    return torch.Generator(device=device or "cpu").manual_seed(
        int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))


def global_loss(loss: torch.Tensor, mesh) -> torch.Tensor:
    """A rank's share of the loss summed over the data group (the loss
    itself without a mesh)."""
    loss = loss.detach()
    if mesh is not None:
        loss = loss.clone()
        dist.all_reduce(loss, group=mesh.data_group)
    return loss


@dataclass
class TrainState:
    """The model (parameters + BN statistics), the optimizer and the step
    counter (the reference counts from 1)."""

    model: torch.nn.Module  # MainModel, StackedHourglass or End2End
    optimizer: HourglassOptimizer
    step: int = 1

    def trees(self):
        """(params, batch_stats, optimizer state) in the JAX package's
        checkpoint layout: ``(EmptyState, TorchRMSpropState(count,
        square_avg))`` as ``{'0': {}, '1': {'count', 'square_avg'}}``, for
        the model's own tree (a detector variant's, or End2End's)."""
        conv = wt.converters_of(self.model)
        sd = self.model.state_dict()
        params, stats = conv.to_jax(sd)
        named = dict(self.model.named_parameters())
        square = {}
        for key, path, kind in conv.param_paths(
                conv.config_of_state_dict(sd)):
            p = named[key]
            v = self.optimizer.square_avg(p)
            v = torch.zeros_like(p) if v is None else v
            wt.put_leaf(square, path, wt.leaf_to_jax(v, kind))
        opt = {"0": {}, "1": {
            "count": np.asarray(self.optimizer.count, np.int32),
            "square_avg": square}}
        return params, stats, opt

    def restore(self, payload) -> None:
        """Load a ``{epoch}.save`` payload (either package's) in place."""
        conv = wt.converters_of(self.model)
        params = payload["state"]["params"]
        stats = payload["state"]["batch_stats"]
        self.model.load_state_dict(conv.from_jax(params, stats))
        rms = payload["optimizer"]["1"]
        count = int(np.asarray(rms["count"]))
        named = dict(self.model.named_parameters())
        for key, path, kind in conv.param_paths(conv.config_of_jax(params)):
            v = wt.leaf_from_jax(wt.get_leaf(rms["square_avg"], path), kind)
            self.optimizer.set_square_avg(named[key], v, count)
        self.optimizer.count = count
        self.step = int(payload["step"])


class HourglassTrainer:
    def __init__(self, variant: str = "torch7",
                 learning_rate: float = 2.5e-4, mesh=None,
                 dtype=torch.float32, remat: bool = False, n_stacks=None,
                 features=None, depth=None, fused_blocks: bool = False,
                 n_modules=None, device=None, joint_remap=None,
                 flip_prob: float = 0.4):
        detectors.check_trainable(variant)
        self.mesh = check_mesh(mesh)
        self.shard = None if self.mesh is None else \
            DataShard(self.mesh.data_group)
        self.remat = remat
        self.variant = variant
        self.learning_rate = learning_rate
        self.dtype = dtype
        self.model_kw = dict(n_stacks=n_stacks, features=features,
                             depth=depth, fused=fused_blocks,
                             n_modules=n_modules)
        self.device = resolve_device(device)
        # Target channels gathered through this map (FROM_H36M_TO_MPII for
        # the fine-tuning); flips w.p. flip_prob (MPII 0.4, H36M never).
        self.remap = None if joint_remap is None else torch.as_tensor(
            np.asarray(joint_remap), dtype=torch.long, device=self.device)
        self.flip_prob = flip_prob

    def init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator().manual_seed(seed)
        model = detectors.make_model(self.variant, self.dtype, generator=gen,
                           **self.model_kw).to(self.device)
        model.train()
        model.remat = self.remat
        set_data_shard(model, self.shard)
        return TrainState(model, hourglass_optimizer(model.parameters(),
                                                     self.learning_rate))

    def batch_tensors(self, batch):
        """A CanvasBatch's arrays as tensors on the trainer's device."""
        return batch_tensors(batch, self.device)

    def train_step(self, state: TrainState, batch: dict,
                   augment: Augment) -> torch.Tensor:
        """One update; returns the loss (a device scalar, not synced). Its
        four phases are the spans ``STEP_RANGES`` (recorded only while a
        profiler records). Under a mesh every rank passes the
        global batch and its draws; the loss returned is the global one."""
        preprocess, forward, backward, optimizer = STEP_RANGES
        total = None
        if self.mesh is not None:
            total = batch["images"].shape[0]
            self.shard.place(self.mesh.rows(total)[0], total)
            batch, augment = local_rows(self.mesh, (batch, augment))
        with span(preprocess):
            crops, targets, _ = preprocess_batch(
                batch["images"], batch["centers"], batch["scales"],
                batch["keypoints"], batch["valid"], augment)
            if self.remap is not None:
                targets = targets[:, self.remap]
        with span(forward):
            state.model.train()
            loss = heatmap_loss(state.model(crops), targets, total)
        with span(backward):
            state.optimizer.zero_grad()
            loss.backward()
            if self.mesh is not None:
                all_reduce_grads(state.model.parameters(),
                                 self.mesh.data_group)
        with span(optimizer):
            state.optimizer.step()
        state.step += 1
        return global_loss(loss, self.mesh)

    @torch.no_grad()
    def overlay_forward(self, state: TrainState, batch: dict):
        """Eval-mode forward on the unaugmented crops: (crops, targets as
        (1, B, H, W, J), predictions (S, B, H, W, J))."""
        crops, targets, _ = preprocess_batch(
            batch["images"], batch["centers"], batch["scales"],
            batch["keypoints"], batch["valid"], None)
        state.model.eval()
        try:
            pred = state.model(crops)
        finally:
            state.model.train()
        return crops, targets.permute(0, 2, 3, 1)[None], pred

    def fit_epoch(self, state: TrainState, pipeline, epoch: int, seed: int,
                  log_every: int = 0, logger=None, group: int = 1):
        """One epoch. Batches are taken in groups of ``group`` (steps of a
        group run in order; the numerics do not depend on it), and the loss
        is logged after a group once ``log_every`` steps have passed since
        the last line. Returns (state, last loss)."""
        last_loss = None
        pending = []
        step_count = last_logged = 0

        def flush():
            nonlocal last_loss, step_count, last_logged
            for batch in pending:
                b = batch["images"].shape[0]
                gen = step_generator(seed, epoch, state.step)
                last_loss = self.train_step(
                    state, batch, sample_augment(gen, b, self.flip_prob))
                step_count += 1
            if pending and log_every and logger and \
                    step_count - last_logged >= log_every:
                logger.info("epoch %d step %d loss %f", epoch, step_count,
                            float(last_loss))
                last_logged = step_count
            pending.clear()

        lead_shape = None
        for batch in pipeline.epoch(epoch):
            d = self.batch_tensors(batch)
            shape = tuple(d["images"].shape)
            if lead_shape is not None and shape != lead_shape:
                flush()
            lead_shape = shape
            pending.append(d)
            if len(pending) >= group:
                flush()
        flush()
        return state, last_loss
