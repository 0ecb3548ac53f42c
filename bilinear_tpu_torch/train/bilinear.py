"""The lifting trainer (counterpart of ``bilinear_tpu/train/bilinear.py``).

The whole normalized split lives on the model's device. An epoch gathers
the split in the order of a permutation drawn from a CPU generator seeded
from (seed, epoch), then runs ``n // batch_size`` steps of ``batch_size``
rows and one tail step of the rest (the reference's DataLoader with
``drop_last=False``, ``train_bilinear.py:56-89``). One step: train-mode
forward (dropout masks from a generator on the device, seeded from (seed,
epoch) and drawn in step order), MSE (``:78``), backward, clip(1.0) and
Adam with the reference's step decay (``:66-83``); the BN running
statistics are updated by the forward itself (torch's BatchNorm1d). The
step counter starts at 1, as the reference's.

Per-step losses stay on the device: ``train_epoch`` returns them as one
tensor, and ``fit``'s hook fetches them once per epoch.

``mesh=`` (``parallel/mesh.py::make_mesh``) trains over ranks, each holding
the whole split and drawing the same permutation and dropout generator:
each step takes the rank's row block of the global batch (a tail batch
that does not divide gives blocks one row apart), the BNs take the global
batch's statistics and the dropout layers the global batch's masks, the
loss is the rank's share of the global mean, and the gradients are summed
over the ranks; with a ``'model'`` group of more than one rank the
network is ``parallel/tp.py::TPBilinearUnit``. The step is then the
one-process step at any dropout rate (JAX's GSPMD computes the same, by
padding the tail instead). ``trees`` gathers a split model into the
one-process layout, and ``restore`` splits it again.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

import torch.distributed as dist

from bilinear_tpu_torch.core.norm import DataShard, set_data_shard
from bilinear_tpu_torch.core.optim import BilinearOptimizer, \
    bilinear_optimizer
from bilinear_tpu_torch.device import resolve_device
from bilinear_tpu_torch.models.bilinear import BilinearUnit
from bilinear_tpu_torch.parallel.mesh import all_reduce_grads, local_rows
from bilinear_tpu_torch.parallel.tp import TPBilinearUnit
from bilinear_tpu_torch.utils import weights as wt


def _seed(seed: int, epoch: int, what: str) -> int:
    digest = hashlib.sha256(f"{seed}:{epoch}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def epoch_permutation(seed: int, epoch: int, n: int) -> torch.Tensor:
    """The order of an epoch's rows (a CPU int64 tensor): the same on
    every device."""
    gen = torch.Generator().manual_seed(_seed(seed, epoch, "permutation"))
    return torch.randperm(n, generator=gen)


@dataclass
class TrainState:
    """The model (parameters + BN statistics), the optimizer and the step
    counter (the reference counts from 1)."""

    model: BilinearUnit  # or a TPBilinearUnit shard
    optimizer: BilinearOptimizer
    step: int = 1

    def trees(self):
        """(params, batch_stats, optimizer state) in the JAX package's
        checkpoint layout; the optimizer as ``{'0': {}, '1': {'count', 'mu',
        'nu'}}`` with the moments in the parameter tree's layout (zeros
        before the first update). A tensor-parallel model is gathered into
        the one-process layout: every rank of its model group calls this."""
        tp = isinstance(self.model, TPBilinearUnit)
        sd = self.model.full_state_dict() if tp else self.model.state_dict()
        params, stats = wt.bilinear_to_jax(sd)
        mu, nu = {}, {}
        for key, p in self.model.named_parameters():
            m = self.optimizer.moments(p)
            mu[key], nu[key] = (torch.zeros_like(p), torch.zeros_like(p)) \
                if m is None else m
        if tp:
            mu, nu = self.model.gather(mu), self.model.gather(nu)
        return params, stats, wt.bilinear_opt_to_jax(self.optimizer.count,
                                                     mu, nu)

    def restore(self, payload) -> None:
        """Load a ``{epoch}.save`` payload (either package's) in place. A
        checkpoint without optimizer state (a served model's) leaves the
        optimizer as it is. A tensor-parallel model takes its shard."""
        state = payload["state"]
        full = wt.bilinear_from_jax(state["params"], state["batch_stats"])
        tp = isinstance(self.model, TPBilinearUnit)
        if tp:
            self.model.load_full(full)
        else:
            self.model.load_state_dict(full)
        if payload["optimizer"]:
            count, mu, nu = wt.bilinear_opt_from_jax(payload["optimizer"])
            if tp:
                mesh = self.model.mesh
                mu = wt.bilinear_tp_shard(mu, mesh.model_index, mesh.model)
                nu = wt.bilinear_tp_shard(nu, mesh.model_index, mesh.model)
            if count:
                for key, p in self.model.named_parameters():
                    self.optimizer.set_moments(p, mu[key], nu[key], count)
            self.optimizer.count = count
        self.step = int(payload["step"])


class BilinearTrainer:
    def __init__(self, batch_size: int = 64,
                 learning_rate: Union[None, float,
                                      Callable[[int], float]] = None,
                 mesh=None, dtype=torch.float32, dropout: float = 0.5,
                 device=None):
        """``learning_rate`` None is the reference's schedule. ``device``
        None is the card, and raises when there is none. ``mesh``: a
        ``parallel/mesh.py::Mesh`` of ranks (None, or one rank, is the
        one-process trainer)."""
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.shard = None if self.mesh is None else \
            DataShard(self.mesh.data_group)
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.dtype = dtype
        self.dropout = dropout
        self.device = resolve_device(device)

    def init_state(self, seed: int = 0) -> TrainState:
        gen = torch.Generator().manual_seed(seed)
        model = BilinearUnit(dropout=self.dropout, dtype=self.dtype,
                             generator=gen).to(self.device)
        model.train()
        if self.mesh is None:
            return TrainState(model, bilinear_optimizer(model.parameters(),
                                                        self.learning_rate))
        if self.mesh.model > 1:
            model = TPBilinearUnit.from_full(model, self.mesh)
        set_data_shard(model, self.shard)
        opt = bilinear_optimizer(model.parameters(), self.learning_rate)
        if self.mesh.model > 1:
            opt.grad_norm = model.global_grad_norm
        return TrainState(model, opt)

    def dropout_generator(self, seed: int, epoch: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_seed(seed, epoch, "dropout"))
        return gen

    def train_step(self, state: TrainState, bx: torch.Tensor,
                   by: torch.Tensor,
                   gen: Optional[torch.Generator]) -> torch.Tensor:
        """One update on a batch already on the device; returns the loss
        (a device scalar, not synced). The model must be in train mode.
        Under a mesh every rank passes the whole global batch and trains
        on its rows; the loss returned is the global one."""
        if self.mesh is not None:
            return self._train_step_mesh(state, bx, by, gen)
        loss = (state.model(bx, gen) - by).square().mean()
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    def _train_step_mesh(self, state: TrainState, bx, by, gen):
        mesh = self.mesh
        n = bx.shape[0]
        self.shard.place(mesh.rows(n)[0], n)
        bx, by = local_rows(mesh, (bx, by))
        out = state.model(bx, gen)
        # This rank's share of the global mean (each model rank of a data
        # block holds the same rows: 1/model of it each).
        local = (out - by).square().sum() / (n * by.shape[1] * mesh.model)
        state.optimizer.zero_grad()
        local.backward()
        if isinstance(state.model, TPBilinearUnit):
            state.model.sync_grads()
        else:
            all_reduce_grads(state.model.parameters(), mesh.data_group)
        state.optimizer.step()
        state.step += 1
        loss = local.detach().clone()
        dist.all_reduce(loss)
        return loss

    def train_epoch(self, state: TrainState, x: torch.Tensor,
                    y: torch.Tensor, epoch: int, seed: int = 0,
                    perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One epoch over (x, y) on the device, its last step the partial
        batch. ``perm`` overrides the epoch's permutation. Returns the
        per-step losses as one device tensor."""
        n, bs = x.shape[0], self.batch_size
        if perm is None:
            perm = epoch_permutation(seed, epoch, n)
        perm = perm.to(x.device)
        xs, ys = x.index_select(0, perm), y.index_select(0, perm)
        gen = self.dropout_generator(seed, epoch)
        state.model.train()
        return torch.stack([
            self.train_step(state, xs[i:i + bs], ys[i:i + bs], gen)
            for i in range(0, n, bs)])

    def fit(self, state: TrainState, x: torch.Tensor, y: torch.Tensor,
            epochs: int, seed: int = 0, start_epoch: int = 0,
            on_epoch_end=None) -> TrainState:
        """Train ``epochs`` epochs after ``start_epoch``.
        ``on_epoch_end(epoch, state, losses)`` is the checkpoint and logging
        hook; a truthy return stops after that epoch."""
        for e in range(start_epoch + 1, start_epoch + epochs + 1):
            losses = self.train_epoch(state, x, y, e, seed)
            if on_epoch_end is not None and on_epoch_end(e, state, losses):
                break
        return state

