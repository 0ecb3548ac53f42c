"""Process groups and local device meshes (counterpart of
``bilinear_tpu/parallel/mesh.py``).

JAX runs every kind of parallelism on one ``Mesh``. The port uses
PyTorch's idiom for each use:

- multi-process data and tensor parallelism: ``torch.distributed``, one
  process per rank (``init_distributed``, ``maybe_init_distributed``), and
  a ``Mesh`` of ranks with a ``'data'`` and a ``'model'`` group
  (``make_mesh``). Rank ``r`` is ``(data index, model index) = divmod(r,
  model)``, the order of JAX's ``devices.reshape(data, model)``. Ranks
  are numbered host by host, ``local_processes`` on each (all on one host
  by default). The backend is ``nccl`` when every rank of a host has a
  card of its own and ``gloo`` on the CPU or when ranks share a card
  (NCCL refuses two ranks on one device; an explicit ``device`` counts as
  shared), chosen from that layout (``rank_layout``), never by trying;
- single-process serving and pipelines: a ``LocalMesh``, a list of local
  devices, which may name one device more than once (the CPU tests use
  ``["cpu"] * k``, the one-card smoke ``["cuda:0"] * k``).

Every process of a data-parallel run holds the whole split, as JAX's
``global_from_host`` assumes, and takes the contiguous row block
``[(p*n)//P, ((p+1)*n)//P)`` of every global batch (``row_block``,
``local_rows``); blocks may differ by one row, where JAX's GSPMD pads. The
losses and BN statistics are weighted by the global count, so a step is the
one-process step.

Spatial sharding (``spatial_sharding``, ``shard_spatial``, JAX's names):
the H axis of an NHWC image cut over a ``LocalMesh`` into contiguous
blocks of whole units of the detector's downsampling factor (``2^(2 +
depth)`` input rows, 64 at the published depth 4), blocks differing by at
most one unit (``row_block`` over the units). Where GSPMD would pad, the
port raises: an H that is no multiple of the factor, or fewer units than
slabs (a slab with less than one row at the hourglass waist). The halo
exchanges GSPMD inserts are ``parallel/spatial.py``'s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device]


def choose_backend(devices: Sequence[DeviceLike]) -> str:
    """``nccl`` when every rank of a host runs on a card of its own, else
    ``gloo`` (ranks on the CPU, or sharing a card: NCCL refuses two ranks
    on one device)."""
    devs = [torch.device(d) for d in devices]
    own = len(set(devs)) == len(devs)
    return "nccl" if own and all(d.type == "cuda" for d in devs) else "gloo"


def rank_layout(num_processes: int, process_id: int,
                local_processes: int = 0, device: DeviceLike = "",
                device_count: Optional[int] = None
                ) -> Tuple[torch.device, str]:
    """(device, backend) of rank ``process_id``. Ranks are numbered host by
    host: each host runs ``local_processes`` of them (all of them when 0),
    host h ranks ``[h*L, (h+1)*L)``, and the local rank is ``process_id %
    L``. A host's ranks all take ``device`` when it is given (an explicit
    device is taken to be shared), else local rank r takes ``cuda:{r %
    device_count}`` (raises without a card). The backend is chosen from
    the host's devices (``choose_backend``), the same on every host."""
    per_host = local_processes or num_processes
    if per_host < 1 or num_processes % per_host:
        raise ValueError(f"{num_processes} ranks do not fill hosts of "
                         f"{per_host}")
    if device:
        devices = [torch.device(device)] * per_host
    else:
        if device_count is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass "
                                   "--device cpu for the plain path")
            device_count = torch.cuda.device_count()
        devices = [torch.device("cuda", r % device_count)
                   for r in range(per_host)]
    return devices[process_id % per_host], choose_backend(devices)


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device: DeviceLike = "",
                     local_processes: int = 0) -> torch.device:
    """Join the process group at ``coordinator_address`` (``host:port``;
    rank 0 listens there) as rank ``process_id`` of ``num_processes``, on
    the device and backend of ``rank_layout``. Returns the rank's
    device."""
    dev, backend = rank_layout(num_processes, process_id, local_processes,
                               device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    return dev


def maybe_init_distributed(cfg) -> Optional[torch.device]:
    """CLI hook: join the process group when the config carries
    ``--coordinator host:port --num-processes N --process-id i`` (and
    ``--local-processes L`` across hosts). Returns the rank's device, or
    None without a coordinator."""
    coordinator = getattr(cfg, "coordinator", "")
    if not coordinator:
        return None
    return init_distributed(coordinator, int(cfg.num_processes),
                            int(cfg.process_id), cfg.device,
                            int(getattr(cfg, "local_processes", 0)))


def start_run(cfg, model: int = 1):
    """A training CLI's ranks: (mesh, device). With ``--coordinator`` the
    process joins the group on its rank's device and the mesh has
    ``model`` ranks per model group; without it (None, the device of
    ``--device``, the card by default)."""
    from bilinear_tpu_torch.device import resolve_device

    device = maybe_init_distributed(cfg)
    if device is not None:
        return make_mesh(model=model), device
    if model > 1:
        raise ValueError("tensor parallelism needs a process group "
                         "(--coordinator/--num-processes/--process-id)")
    return None, resolve_device(cfg.device or None)


def backend() -> str:
    """The process group's backend, '' without one."""
    return dist.get_backend() if dist.is_initialized() else ""


def is_primary(mesh) -> bool:
    """Rank 0, or a run without a mesh: the rank that logs and saves."""
    return mesh is None or mesh.primary


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def row_block(n: int, index: int, parts: int) -> Tuple[int, int]:
    """Rows ``[(index*n)//parts, ((index+1)*n)//parts)`` of ``n``."""
    return (index * n) // parts, ((index + 1) * n) // parts


@dataclass
class Mesh:
    """This rank's place in a (data, model) grid of ranks and the groups
    it belongs to (None for a group of one)."""

    data: int
    model: int
    rank: int = 0
    data_group: object = None  # the ranks of this model index
    model_group: object = None  # the ranks of this data index

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> Tuple[int, int]:
        """This rank's row block of a global batch of ``n`` rows."""
        return row_block(n, self.data_index, self.data)

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def all_reduce_grads(params, group=None) -> None:
    """Sum the gradients of ``params`` over ``group`` (the world when
    None), in one flat buffer per call."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, f in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(f)


def make_mesh(model: int = 1) -> Mesh:
    """A (data, model) mesh over the ranks of the process group (one rank
    without one): groups of ``model`` ranks, and every rank not in a
    model group on the data axis. Every rank must call this in the same
    order: it makes the groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1 or world % model:
        raise ValueError(f"{world} ranks cannot form model groups of "
                         f"{model}")
    data = world // model
    mesh = Mesh(data, model, rank)
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == mesh.model_index:
                mesh.data_group = g
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == mesh.data_index:
                mesh.model_group = g
    return mesh


def _leaves(tree):
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, tuple):
        yield tree
        return
    for v in tree:
        yield from _leaves(v)


def local_rows(mesh: Mesh, tree):
    """This rank's row block of a tree (dicts and tuples, NamedTuples
    among them) of arrays or tensors that every process holds in full: the
    counterpart of ``global_from_host`` / ``global_batch``. Every array
    leaf must be batch-like: at least 1-d, with the tree's one leading
    length. A stats vector or a 0-d array riding in the tree is refused,
    not split; a leaf that is no array (a per-batch int, a generator)
    passes through."""
    lengths = set()
    for x in _leaves(tree):
        if not hasattr(x, "ndim"):
            continue
        if x.ndim < 1:
            raise ValueError(f"local_rows leaf of shape {tuple(x.shape)} "
                             "is not batch-like; pass stats and scalars "
                             "separately")
        lengths.add(x.shape[0])
    if len(lengths) > 1:
        raise ValueError(f"local_rows leaves of leading lengths "
                         f"{sorted(lengths)} are not one batch; pass stats "
                         "and scalars separately")
    lo, hi = mesh.rows(lengths.pop() if lengths else 0)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, tuple):
            parts = [take(v) for v in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        return x[lo:hi] if hasattr(x, "ndim") else x

    return take(tree)


class LocalMesh:
    """A list of local devices, the counterpart of a single-process JAX
    mesh: a server splits a request's rows over them, a pipeline puts its
    stages on them. A device may appear more than once."""

    def __init__(self, devices: Sequence[DeviceLike]):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a local mesh needs at least one device")

    def __len__(self) -> int:
        return len(self.devices)


def as_local_mesh(mesh) -> LocalMesh:
    """A ``LocalMesh`` as given, or one of a list of devices."""
    return mesh if isinstance(mesh, LocalMesh) else LocalMesh(mesh)


def make_local_mesh(devices: Optional[Sequence[DeviceLike]] = None
                    ) -> LocalMesh:
    """Every visible card by default."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return LocalMesh(devices)


def make_stage_mesh(devices: Optional[Sequence[DeviceLike]] = None,
                    stages: Optional[int] = None) -> LocalMesh:
    """The devices of a pipeline's stages: the first ``stages`` of
    ``devices`` (every visible card by default)."""
    devices = list(devices if devices is not None
                   else make_local_mesh().devices)
    if stages is not None:
        if stages > len(devices):
            raise ValueError(
                f"requested {stages} stages but only {len(devices)} devices "
                "are available"
            )
        devices = devices[:stages]
    return LocalMesh(devices)


@dataclass(frozen=True)
class SpatialSharding:
    """Axis ``axis`` of an ``ndim``-d tensor cut over ``devices``, in
    order, into contiguous blocks of whole units of ``unit`` rows."""

    devices: Tuple[torch.device, ...]
    ndim: int
    axis: int
    unit: int

    def blocks(self, n: int) -> List[Tuple[int, int]]:
        """Each device's rows ``[lo, hi)`` of an axis of ``n`` rows:
        ``row_block`` over whole units, so blocks differ by at most one
        unit. Raises where GSPMD would pad."""
        parts = len(self.devices)
        if n % self.unit:
            raise ValueError(
                f"H = {n} is not a multiple of the model's downsampling "
                f"factor {self.unit}: a slab boundary would fall inside a "
                "pooling window")
        units = n // self.unit
        if units < parts:
            raise ValueError(
                f"H = {n} holds {units} unit(s) of the model's downsampling "
                f"factor {self.unit}, fewer than the {parts} slabs: a slab "
                "would have less than one row at the hourglass waist")
        return [(lo * self.unit, hi * self.unit)
                for lo, hi in (row_block(units, i, parts)
                               for i in range(parts))]


def spatial_sharding(mesh, ndim: int = 4, axis: int = 1, *,
                     unit: int) -> SpatialSharding:
    """The plan of a spatial split (JAX's ``spatial_sharding``): axis
    ``axis`` (H of NHWC by default) of an ``ndim``-d tensor over the
    devices of ``mesh`` (a ``LocalMesh`` or a list of devices), in blocks
    of whole ``unit`` rows (a detector's downsampling factor,
    ``spatial.downsampling_factor``)."""
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} of a {ndim}-d tensor")
    return SpatialSharding(tuple(as_local_mesh(mesh).devices), ndim,
                           axis % ndim, unit)


def shard_spatial(mesh, x, axis: int = 1, *,
                  unit: int) -> List[torch.Tensor]:
    """``x`` (a tensor or an array) cut along ``axis`` into the blocks of
    ``spatial_sharding``, block i on device i (a view where it already
    lies there). ``gather_spatial`` puts them back."""
    x = torch.as_tensor(x)
    plan = spatial_sharding(mesh, x.ndim, axis, unit=unit)
    return [x.narrow(plan.axis, lo, hi - lo).to(dev)
            for dev, (lo, hi) in zip(plan.devices,
                                     plan.blocks(x.shape[plan.axis]))]


def gather_spatial(slabs: Sequence[torch.Tensor],
                   axis: int = 1) -> torch.Tensor:
    """Slabs put back together along ``axis`` on the first slab's
    device."""
    dev = slabs[0].device
    return torch.cat([t.to(dev) for t in slabs], dim=axis)
