"""Tensor parallelism of the lifting MLP over a mesh's ``'model'`` group
(counterpart of ``bilinear_tpu/parallel/tp.py``).

The Megatron pairing, as JAX's shardings state it, with the collectives
written out (JAX lets GSPMD insert them):

- ``encode`` and the FIRST linear of each residual pair are
  column-parallel: each model rank holds a block of their output features,
  with the bias and the BN of that block (BN is per feature). The encode's
  output is gathered back to full width for the residual stream;
- the SECOND linear of each pair is row-parallel: each rank holds the
  weight's input columns of its block, the partial products are
  all-reduced, then its bias and BN run replicated;
- ``decode`` is replicated.

Every collective is ``torch.distributed.nn.functional.all_reduce``, whose
backward is again an all-reduce: autograd then gives each rank the
gradient of the sum of all ranks' losses, so each rank's loss is its rows'
share of the global loss divided by the model group's size
(``train/bilinear.py``), a parameter held by several ranks has its
gradient summed over them (``sync_grads``), and the clip takes the norm of
the whole model: the sharded leaves' squares summed over the model group,
the replicated ones counted once (``global_grad_norm``), as JAX's
``clip_by_global_norm`` under GSPMD computes it. Adam's moments live with
their shard. Dropout draws the mask of the whole global batch and full
width, and keeps this rank's rows and features, so a step equals the
one-process step at any rate.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from bilinear_tpu_torch.core.norm import active_shard, batch_norm
from bilinear_tpu_torch.core.precision import wide
from bilinear_tpu_torch.models.bilinear import (
    IN_FEATURES,
    OUT_FEATURES,
    BilinearUnit,
    HeavyLinear,
    dropout,
    linear_in,
)
from bilinear_tpu_torch.parallel.mesh import Mesh, all_reduce_grads
from bilinear_tpu_torch.utils.weights import bilinear_tp_gather, \
    bilinear_tp_shard, _tp_split_dim


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)


class TPBilinearUnit(nn.Module):
    """This model rank's shard of ``BilinearUnit``, with the same
    state_dict keys (shard-shaped: ``utils/weights.py::bilinear_tp_shard``).
    """

    data_shard = None  # core/norm.py::set_data_shard

    def __init__(self, mesh: Mesh, hidden: int = 1024, num_blocks: int = 2,
                 dropout: float = 0.5, bn_momentum: Optional[float] = 0.1,
                 dtype=torch.float32):
        super().__init__()
        if hidden % mesh.model:
            raise ValueError(f"the model group ({mesh.model}) does not "
                             f"divide the hidden width {hidden}")
        self.mesh = mesh
        self.hidden = hidden
        self.dtype = dtype
        self.p = dropout
        block = hidden // mesh.model
        kw = dict(dropout=dropout, bn_momentum=bn_momentum, dtype=dtype)
        self.encode = HeavyLinear(IN_FEATURES, block, **kw)
        self.bilinear = nn.ModuleList(
            nn.ModuleList([HeavyLinear(hidden, block, **kw),
                           HeavyLinear(block, hidden, **kw)])
            for _ in range(num_blocks))
        self.decode = nn.Linear(hidden, OUT_FEATURES)
        self._cols = slice(mesh.model_index * block,
                           (mesh.model_index + 1) * block)

    @classmethod
    def from_full(cls, full: BilinearUnit, mesh: Mesh) -> "TPBilinearUnit":
        """This rank's shard of a whole ``BilinearUnit`` (on its device)."""
        hidden = full.decode.in_features
        tp = cls(mesh, hidden=hidden, num_blocks=len(full.bilinear),
                 dropout=full.encode[3].p,
                 bn_momentum=full.encode[1].momentum, dtype=full.dtype)
        tp.load_full(full.state_dict())
        return tp.to(full.decode.weight.device).train(full.training)

    def load_full(self, state: Dict[str, torch.Tensor]) -> None:
        """Load this rank's shard of a full state_dict."""
        self.load_state_dict(bilinear_tp_shard(
            state, self.mesh.model_index, self.mesh.model))

    def gather(self, shard: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The full form of ``shard`` (this rank's state_dict, or any map
        keyed by its names), gathered over the model group on the CPU
        (gloo's gather takes CPU tensors). A collective: every rank of the
        group calls it."""
        local = {k: v.detach().cpu() for k, v in shard.items()}
        parts: List[dict] = [None] * self.mesh.model
        dist.all_gather_object(parts, local, group=self.mesh.model_group)
        return bilinear_tp_gather(parts)

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        return self.gather(self.state_dict())

    def sharded(self, name: str) -> bool:
        """Whether parameter ``name`` is split over the model group."""
        return _tp_split_dim(name) is not None

    # ------------------------------------------------------------ forward
    def _window(self, x: torch.Tensor, cols: Optional[slice]):
        """Dropout window: the global batch's mask at full width, this
        rank's rows and (for a sharded activation) features."""
        shard = active_shard(self)
        total, lo = (shard.total, shard.offset) if shard else (x.shape[0], 0)
        rows = slice(lo, lo + x.shape[0])
        return ((total, self.hidden),
                (rows, cols if cols is not None else slice(None)))

    def _finish(self, layer: HeavyLinear, h: torch.Tensor, gen,
                cols: Optional[slice]) -> torch.Tensor:
        bn = layer[1]
        h = torch.relu(batch_norm(bn, h.to(wide(self.dtype))).to(self.dtype))
        return dropout(h, self.p, self.training, gen, self._window(h, cols))

    def _column(self, layer: HeavyLinear, x, gen) -> torch.Tensor:
        return self._finish(layer, linear_in(layer[0], x, self.dtype), gen,
                            self._cols)

    def _row(self, layer: HeavyLinear, h, gen) -> torch.Tensor:
        lin = layer[0]
        part = F.linear(h.to(self.dtype), lin.weight.to(self.dtype))
        y = _all_reduce(part, self.mesh.model_group) + lin.bias.to(self.dtype)
        return self._finish(layer, y, gen, None)

    def _gather_features(self, h: torch.Tensor) -> torch.Tensor:
        """The full-width activation from every rank's block (a zero-padded
        all-reduce, whose backward hands each rank its block's gradient)."""
        left = self._cols.start
        right = self.hidden - self._cols.stop
        full = F.pad(h, (left, right))
        return _all_reduce(full, self.mesh.model_group)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._gather_features(
            self._column(self.encode, x.to(self.dtype), generator))
        for first, second in self.bilinear:
            skip = x
            x = self._row(second, self._column(first, x, generator),
                          generator) + skip
        return linear_in(self.decode, x, self.dtype).to(wide(self.dtype))

    # ------------------------------------------------------- the update
    def sync_grads(self) -> None:
        """Sum each gradient over the ranks that hold the parameter: a
        shard over its data group, a replicated one over the world."""
        named = list(self.named_parameters())
        sharded = [p for k, p in named if self.sharded(k)]
        replicated = [p for k, p in named if not self.sharded(k)]
        if self.mesh.data_group is not None:
            all_reduce_grads(sharded, self.mesh.data_group)
        all_reduce_grads(replicated, None)

    def global_grad_norm(self) -> torch.Tensor:
        """The 2-norm of the whole model's gradient: the shards' squares
        summed over the model group, the replicated leaves once."""
        named = [(k, p.grad) for k, p in self.named_parameters()
                 if p.grad is not None]
        dev = self.decode.weight.device
        sq_shard = torch.zeros((), device=dev)
        sq_rep = torch.zeros((), device=dev)
        for k, g in named:
            sq = g.detach().float().square().sum()
            if self.sharded(k):
                sq_shard = sq_shard + sq
            else:
                sq_rep = sq_rep + sq
        dist.all_reduce(sq_shard, group=self.mesh.model_group)
        return (sq_shard + sq_rep).sqrt()
