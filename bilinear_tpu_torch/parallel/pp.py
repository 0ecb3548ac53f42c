"""Pipeline parallelism over the torch7 detector's stacks (counterpart of
``bilinear_tpu/parallel/pp.py``).

The 8 stacks of ``MainModel`` chain through the ``inter`` feedback tensor,
so they split into stages: stage ``s`` of ``S`` holds stacks ``[s*k,
(s+1)*k)``, ``k = n_stacks / S``, on device ``s`` of a stage mesh
(``parallel/mesh.py::make_stage_mesh``, local devices; one may repeat).
One process drives them: ``StemBlock``/``StackBlock`` are views over a
``MainModel``'s own modules (no weight is copied; the final stack's absent
feedback convs are a no-op), and a microbatch moves from stage to stage
with ``.to(device)``. There is no point-to-point communication: gloo cannot
send CUDA tensors and NCCL refuses two ranks on one card.

- ``make_pipeline_fn`` / ``pipeline_forward``: the synchronous schedule of
  ``M + S - 1`` ticks (at tick ``t`` stage ``s`` runs microbatch ``t - s``)
  in eval mode, returning the last stack's heatmaps. The stem runs once on
  the whole batch. ``fused``/``quantize`` are MainModel's knobs, so each
  stage keeps its kernels: K3 eval per ResModule call, or K6/K7 per int8
  conv. A ResModule is called once per microbatch, so a forward launches
  the stem's 3 ResModules once and the stacks' ``104 / 8`` per stack once
  per microbatch (at full width ``3 + 104 M`` K3 launches).
- ``pipeline_end2end``: the End2End frame->3D chain with its detector
  pipelined, then ``decode_to_normalized`` and the lifter (plain, as in
  JAX and the port's ``End2End``).
- ``make_pp_loss_fn`` / ``make_pp_train_step``: GPipe. The stem runs per
  microbatch, each stack's BNs take per-microbatch batch statistics
  applied in microbatch order, autograd runs across the devices, the loss
  is the mean over the M microbatches of the sum over stacks of the
  per-stack MSE, and one clip + RMSprop update covers the stem and every
  stack: a one-process step with gradients accumulated over the same
  microbatches.

JAX's divisibility errors are kept: stacks by stages, batch by
microbatches, and more stages than devices (``make_stage_mesh``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from bilinear_tpu_torch.core.optim import hourglass_optimizer
from bilinear_tpu_torch.models.bilinear import BilinearUnit
from bilinear_tpu_torch.models.hourglass_torch7 import (
    MainModel,
    N_DEPTH,
    N_FEATURES,
    N_JOINTS,
)
from bilinear_tpu_torch.ops.decode import decode_to_normalized
from bilinear_tpu_torch.parallel.mesh import LocalMesh, as_local_mesh, \
    make_stage_mesh  # noqa: F401  (JAX's parallel/pp.py has it here)
from bilinear_tpu_torch.utils import weights as wt


class StemBlock:
    """MainModel's stem as a view: the same modules, no copy."""

    def __init__(self, model: MainModel):
        self.model = model

    def modules(self) -> List[nn.Module]:
        return [self.model.beforeHourglass]

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        return self.model.stem(images)


class StackBlock:
    """Stack ``index`` of a MainModel as a view: (heatmaps, next inter);
    the final stack's feedback is a no-op."""

    def __init__(self, model: MainModel, index: int):
        self.model = model
        self.index = index

    def modules(self) -> List[nn.Module]:
        return self.model.stack_modules(self.index)

    def __call__(self, inter: torch.Tensor):
        return self.model.stack(self.index, inter)


def _as_model(variables, n_stacks, features, depth, dtype, fused, quantize
              ) -> MainModel:
    """A MainModel as given, or one built from a JAX MainModel tree
    (``{"params", "batch_stats"}``, numpy leaves) with the knobs."""
    if isinstance(variables, MainModel):
        return variables
    model = MainModel(n_stacks=n_stacks, features=features, depth=depth,
                      dtype=dtype, fused=fused, quantize=quantize)
    model.load_state_dict(wt.hourglass_torch7_from_jax(
        variables["params"], variables["batch_stats"]))
    return model


class _Pipeline:
    """A MainModel's stem and stacks placed on a stage mesh."""

    def __init__(self, model: MainModel, mesh: LocalMesh):
        n_stages = len(mesh)
        n_stacks = model.n_stacks
        if n_stacks % n_stages:
            raise ValueError(
                f"{n_stages} stages do not divide {n_stacks} stacks")
        self.model = model
        self.devices = mesh.devices
        self.local = n_stacks // n_stages
        self.stem = StemBlock(model)
        self.stages = [[StackBlock(model, s * self.local + j)
                        for j in range(self.local)]
                       for s in range(n_stages)]
        for m in self.stem.modules():
            m.to(self.devices[0])
        for dev, blocks in zip(self.devices, self.stages):
            for b in blocks:
                for m in b.modules():
                    m.to(dev)

    def microbatches(self, batch: int, microbatches: Optional[int]) -> int:
        m = microbatches if microbatches is not None else len(self.stages)
        if batch % m:
            raise ValueError(f"batch {batch} does not divide {m} "
                             "microbatches")
        return m

    def run(self, stem_outs: Sequence[torch.Tensor],
            on_stack: Callable[[int, int, torch.Tensor], None]) -> None:
        """The synchronous schedule over ``M + S - 1`` ticks: at tick ``t``
        stage ``s`` runs microbatch ``t - s`` through its stacks, calling
        ``on_stack(microbatch, stack, heatmaps)`` after each, and hands its
        ``inter`` to stage ``s + 1``."""
        n_stages = len(self.stages)
        n_micro = len(stem_outs)
        waiting: List[Optional[torch.Tensor]] = [None] * n_stages
        for t in range(n_micro + n_stages - 1):
            # Later stages first: each takes what the stage before it
            # handed over at the previous tick.
            for s in reversed(range(n_stages)):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                inter = stem_outs[m].to(self.devices[0]) if s == 0 \
                    else waiting[s]
                for block in self.stages[s]:
                    heat, inter = block(inter)
                    on_stack(m, block.index, heat)
                if s + 1 < n_stages:
                    waiting[s + 1] = inter.to(self.devices[s + 1])


def make_pipeline_fn(variables, mesh, *, n_stacks: int = 8,
                     features: int = N_FEATURES, n_joints: int = N_JOINTS,
                     depth: int = N_DEPTH, dtype=torch.float32,
                     microbatches: Optional[int] = None, fused: bool = False,
                     quantize: Optional[str] = None):
    """The reusable eval-mode pipelined forward: ``fn(images (B, R, R, 3))
    -> the last stack's heatmaps (B, R/4, R/4, J)`` on the first stage's
    device. ``variables``: a MainModel (its own knobs and size; its
    modules are moved to their stages) or a JAX MainModel tree (built with
    the knobs). ``mesh``: a stage mesh or a list of devices."""
    del n_joints  # the tree or the model carries it
    model = _as_model(variables, n_stacks, features, depth, dtype, fused,
                      quantize)
    pipe = _Pipeline(model, as_local_mesh(mesh))

    def fn(images: torch.Tensor) -> torch.Tensor:
        n_micro = pipe.microbatches(images.shape[0], microbatches)
        last = model.n_stacks - 1
        outs: List[Optional[torch.Tensor]] = [None] * n_micro

        def keep(m, i, heat):
            if i == last:
                outs[m] = heat

        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                x = pipe.stem(images.to(pipe.devices[0]))
                pipe.run(x.chunk(n_micro), keep)
        finally:
            model.train(was_training)
        return torch.cat([o.to(pipe.devices[0]) for o in outs])

    return fn


def pipeline_forward(variables, images: torch.Tensor, mesh, *,
                     n_stacks: int = 8, features: int = N_FEATURES,
                     n_joints: int = N_JOINTS, depth: int = N_DEPTH,
                     dtype=torch.float32, microbatches: Optional[int] = None,
                     fused: bool = False, quantize: Optional[str] = None
                     ) -> torch.Tensor:
    """One call of ``make_pipeline_fn`` (a serving loop should keep the
    function). Equals ``MainModel(images)[-1]`` in eval mode."""
    return make_pipeline_fn(
        variables, mesh, n_stacks=n_stacks, features=features,
        n_joints=n_joints, depth=depth, dtype=dtype,
        microbatches=microbatches, fused=fused, quantize=quantize)(images)


def pipeline_end2end(variables, images, centers, scales, mean_part,
                     std_part, mesh, *, temperature: float = 10.0,
                     n_stacks: int = 8, features: int = N_FEATURES,
                     n_joints: int = N_JOINTS, depth: int = N_DEPTH,
                     dtype=torch.float32, microbatches: Optional[int] = None,
                     fused: bool = False, quantize: Optional[str] = None):
    """The End2End frame->3D chain (torch7 detector) with the detector
    pipelined: (pose_img (B, 16, 2), normalized pose_3d (B, 48)), as
    ``End2End(...)[1:]`` in eval mode. ``variables``: an End2End (torch7)
    or its JAX tree."""
    if isinstance(variables, nn.Module):
        detector, lifter = variables.hourglass, variables.bilinear
    else:
        detector = {col: tree["hourglass"] for col, tree in variables.items()}
        lifter = BilinearUnit(dtype=dtype)
        lifter.load_state_dict(wt.bilinear_from_jax(
            variables["params"]["bilinear"],
            variables["batch_stats"]["bilinear"]))
    heat = pipeline_forward(
        detector, images, mesh, n_stacks=n_stacks, features=features,
        n_joints=n_joints, depth=depth, dtype=dtype,
        microbatches=microbatches, fused=fused, quantize=quantize)
    dev = heat.device

    def on(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev)

    pose_img, normalized = decode_to_normalized(
        heat, on(centers), on(scales), on(mean_part), on(std_part),
        temperature)
    was_training = lifter.training
    lifter.to(dev).eval()
    try:
        with torch.no_grad():
            pose_3d = lifter(normalized)
    finally:
        lifter.train(was_training)
    return pose_img, pose_3d


def make_pp_loss_fn(model: MainModel, mesh,
                    microbatches: Optional[int] = None):
    """The differentiable pipeline loss: ``loss_fn(crops (B, R, R, 3),
    targets (B, J, R/4, R/4)) -> loss`` in train mode (BN statistics
    updated per microbatch, in order). The model's modules are moved to
    their stages."""
    pipe = _Pipeline(model, as_local_mesh(mesh))

    def loss_fn(crops: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        n_micro = pipe.microbatches(crops.shape[0], microbatches)
        dev0 = pipe.devices[0]
        model.train()
        stem_outs = [pipe.stem(x) for x in crops.to(dev0).chunk(n_micro)]
        tgts = targets.permute(0, 2, 3, 1).chunk(n_micro)
        parts: List[torch.Tensor] = []

        def add(m, i, heat):
            tgt = tgts[m].to(heat.device)
            parts.append((heat - tgt).square().mean().to(dev0))

        pipe.run(stem_outs, add)
        return torch.stack(parts).sum() / n_micro

    return loss_fn


def make_pp_train_step(model: MainModel, mesh,
                       optimizer=None, learning_rate: float = 2.5e-4,
                       microbatches: Optional[int] = None):
    """The GPipe train step: ``step(crops, targets) -> loss`` (detached):
    forward and backward of ``make_pp_loss_fn``, then one clip(1) +
    RMSprop update of every parameter. ``optimizer`` defaults to
    ``hourglass_optimizer(model.parameters(), learning_rate)``, made after
    the modules are placed."""
    loss_fn = make_pp_loss_fn(model, mesh, microbatches)
    if optimizer is None:
        optimizer = hourglass_optimizer(model.parameters(), learning_rate)

    def step(crops: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad()
        loss = loss_fn(crops, targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    step.optimizer = optimizer
    return step
