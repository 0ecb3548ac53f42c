"""Spatial sharding of the detectors' eval forward: the image's H axis
split over a local mesh (JAX's ``spatial_sharding`` / ``shard_spatial``,
``bilinear_tpu/parallel/mesh.py:176-190``, which JAX runs on the eval
forward of ``MainModel`` and ``StackedHourglass`` alone).

In JAX, GSPMD partitions the jitted forward and inserts the halo exchanges
at the shard edges. The port has no partitioner, and ``Slabs`` stands in
for one: an activation held as row slabs, slab i on device i of the mesh
(a device may repeat), that takes every torch function the model's forward
calls on it (``__torch_function__``; K3's and the int8 conv's wrappers
hand their calls over with ``handle_torch_function``). So
``spatial_forward`` runs the models' own forward code unchanged, op by op
over all slabs: no slab ever runs ahead of the others. Each function runs
on every slab in turn, except:

- a convolution whose kernel spans more than one row (``F.conv2d``: the
  stem's stride-2 7x7, the standard blocks' 3x3s): each slab takes its
  neighbours' ``p`` edge rows (``p`` the conv's H padding) and ``p`` zero
  rows beyond the image's own edges, and the conv runs with no H padding.
  Output row j of a slab starting at global row r0 then reads global rows
  r0 + s*j - p .. r0 + s*j + p, the whole image's, as long as r0 is a
  multiple of the stride s (a padded slab would shift them by p);
- K3 (``ops/resmodule.py::res_block_eval``, a fused ResModule): one row of
  each neighbour (none beyond the image's edges, where the block's own zero
  padding is right), K3 on the haloed slab, the halo rows' outputs
  cropped. BN in eval is pointwise, so the halo rows reach the 3x3 as in
  the whole image, and its padding spoils only the rows cropped;
- an int8 conv (``ops/int8.py::conv2d``), in lockstep: K6's first stage on
  every slab (each sample's max|x|), the maximum over the slabs and the
  scale (``int8.slab_scale``), then on every slab, haloed as for K3 where
  the kernel is 3x3, K6's second stage with that scale, K7, the crop. Every
  slab quantises with the whole sample's scale: the unsharded bits;
- max-pooling (and the nearest x2 upsampling, which needs nothing) runs per
  slab: exact while every slab boundary is even at every level, which
  blocks of whole units of the downsampling factor
  (``mesh.spatial_sharding``) guarantee, and checked at each pool.

A halo is taken by slicing and ``.to(device)``: no point-to-point
communication (devices may repeat, and gloo cannot send CUDA tensors), as
in ``parallel/pp.py``. The model lies on the mesh's first device;
``make_spatial_fn`` copies its weights once to each other device of the
mesh (``Weights``), and a slab's op takes them from there. A mesh of one
repeated device (the CPU tests' ``["cpu"] * S``, one card's ``["cuda:0"]
* S``) copies nothing.

Counters: ``EXCHANGES`` (one per sharded op that takes halo rows),
``EXCHANGE_BYTES`` (the neighbours' rows moved; zero rows not counted) and
``COPIED_BYTES`` (tensors other than slabs copied to a slab's device: the
weights once per device, then at each use whatever is no stored weight,
such as a weight cast to bf16).
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from bilinear_tpu_torch.core.precision import CL
from bilinear_tpu_torch.ops import int8
from bilinear_tpu_torch.ops import resmodule as rk
from bilinear_tpu_torch.parallel.mesh import as_local_mesh, \
    gather_spatial, shard_spatial

EXCHANGES = 0
EXCHANGE_BYTES = 0
COPIED_BYTES = 0


class Slabs:
    """An activation cut into row slabs, slab i on mesh device i. Torch
    functions, tensor methods and addition on it run on every slab (the
    module docstring's exceptions aside); a tensor property is the slabs'
    common value. ``weights`` puts the model's weights on each slab's
    device."""

    __slots__ = ("parts", "weights")

    def __init__(self, parts: Sequence[torch.Tensor],
                 weights: Optional["Weights"] = None):
        self.parts = list(parts)
        self.weights = weights or Weights(None, [])

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        rule = _RULES.get(func)
        if rule is not None:
            return rule(*args, **(kwargs or {}))
        return _each(func, args, kwargs or {})

    def __getattr__(self, name):
        attr = getattr(torch.Tensor, name, None)
        if callable(attr):
            return lambda *a, **k: _each(attr, (self,) + a, k)
        values = {getattr(t, name) for t in self.parts}
        if len(values) != 1:
            raise AttributeError(f"the slabs differ in {name}: {values}")
        return values.pop()


def _binary(name):
    method = getattr(torch.Tensor, name)
    return lambda self, other: _each(method, (self, other), {})


for _name in ("__add__", "__radd__"):  # the models' only operator
    setattr(Slabs, _name, _binary(_name))


def _slabs_in(obj, found: List[Slabs]) -> None:
    if isinstance(obj, Slabs):
        found.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _slabs_in(v, found)
    elif isinstance(obj, dict):
        for v in obj.values():
            _slabs_in(v, found)


def _copy(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    global COPIED_BYTES
    COPIED_BYTES += t.numel() * t.element_size()
    return t.to(dev)


class Weights:
    """A model's weights on every mesh device other than its own, copied
    once and looked up at each use: the storages of its parameters and
    buffers (a view of one, as ``ResModule.res_params`` makes, is rebuilt
    on the copy), and each int8 conv's prepared kernel, copied when it is
    first asked for. Weights changed or moved since (a reload) are copied
    again by ``refresh``; any other tensor is copied at each use."""

    def __init__(self, model, devices: Sequence[torch.device]):
        placed = [torch.empty(0, device=d).device for d in devices]
        self.home = placed[0] if placed else None
        self.devices = [d for d in dict.fromkeys(placed) if d != self.home]
        self.tensors = [] if model is None else list(itertools.chain(
            model.parameters(), model.buffers()))
        self.versions = None
        self.storages = {}
        self.kernels = {}
        self.refresh()

    def refresh(self) -> None:
        """Copy the storages again if a weight changed or moved since. Each
        source storage is kept beside its copies, so that no other tensor
        takes its address while the copies are looked up by it."""
        if not self.devices:
            return
        versions = [(t._version, t.data_ptr()) for t in self.tensors]
        if versions == self.versions:
            return
        self.versions, self.storages = versions, {}
        for t in self.tensors:
            st = t.untyped_storage()
            raw = torch.empty(0, dtype=torch.uint8, device=t.device).set_(st)
            for dev in self.devices:
                if (st.data_ptr(), dev) not in self.storages:
                    self.storages[st.data_ptr(), dev] = \
                        (st, _copy(raw, dev).untyped_storage())

    def to(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """``t`` on ``dev``: as it lies, a view of a stored copy, or a new
        copy."""
        if t.device == dev:
            return t
        hit = self.storages.get((t.untyped_storage().data_ptr(), dev)) \
            if t.device == self.home else None
        if hit is None:
            return _copy(t, dev)
        return torch.empty(0, dtype=t.dtype, device=dev).set_(
            hit[1], t.storage_offset(), t.shape, t.stride())

    def kernel(self, conv, prepared, dev: torch.device):
        """``conv``'s prepared int8 kernel ``prepared`` on ``dev``."""
        if prepared.kq.device == dev:
            return prepared
        hit = self.kernels.get((id(conv), dev))
        if hit is None or hit[0] is not prepared:
            hit = (prepared, _like(prepared, [
                None if v is None else _copy(v, dev) for v in prepared]))
            self.kernels[id(conv), dev] = hit
        return hit[1]


def _part(obj, i: int, dev: torch.device, weights: Weights):
    """``obj`` as slab i sees it: slabs replaced by their i-th, tensors on
    another device taken from ``weights``."""
    if isinstance(obj, Slabs):
        return obj.parts[i]
    if isinstance(obj, torch.Tensor):
        return weights.to(obj, dev)
    if isinstance(obj, (list, tuple)):
        return _like(obj, [_part(v, i, dev, weights) for v in obj])
    if isinstance(obj, dict):
        return {k: _part(v, i, dev, weights) for k, v in obj.items()}
    return obj


def _like(seq, items: list):
    """``items`` in the sequence type of ``seq`` (a NamedTuple too)."""
    return type(seq)(*items) if hasattr(seq, "_fields") else type(seq)(items)


def _wrap(outs: list, weights: Weights):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return Slabs(outs, weights)
    if any(o != first for o in outs[1:]):
        raise ValueError(f"the slabs disagree: {outs}")
    return first


def _each(func, args, kwargs):
    """``func`` on every slab in turn."""
    found: List[Slabs] = []
    _slabs_in((args, kwargs), found)
    n = len(found[0].parts)
    if any(len(s.parts) != n for s in found):
        raise ValueError("slabs of different meshes in one call")
    weights = found[0].weights
    outs = []
    for i in range(n):
        dev = found[0].parts[i].device
        outs.append(func(*_part(args, i, dev, weights),
                         **_part(kwargs, i, dev, weights)))
    return _wrap(outs, weights)


def _edge_rows(t: torch.Tensor, r: int, dim: int, last: bool,
               dev: torch.device) -> torch.Tensor:
    """The ``r`` first (or ``last``) rows of slab ``t`` along ``dim``, on
    ``dev``."""
    global EXCHANGE_BYTES
    n = t.shape[dim]
    if n < r:
        raise ValueError(f"a slab of {n} rows cannot give a halo of {r}")
    rows = t.narrow(dim, n - r if last else 0, r)
    EXCHANGE_BYTES += rows.numel() * rows.element_size()
    return rows.to(dev)


def halo(parts: Sequence[torch.Tensor], r: int, dim: int,
         zeros: bool) -> List[torch.Tensor]:
    """Every slab with ``r`` rows of each neighbour along ``dim`` and, with
    ``zeros``, ``r`` zero rows beyond the image's edges (else none there),
    in the slab's memory format. One exchange."""
    global EXCHANGES
    n = len(parts)
    if r == 0 or (n == 1 and not zeros):
        return list(parts)
    if n > 1:
        EXCHANGES += 1
    out = []
    for i, t in enumerate(parts):
        dev = t.device
        pieces = [t]
        if i > 0:
            pieces.insert(0, _edge_rows(parts[i - 1], r, dim, True, dev))
        elif zeros:
            pieces.insert(0, torch.zeros_like(t.narrow(dim, 0, r)))
        if i + 1 < n:
            pieces.append(_edge_rows(parts[i + 1], r, dim, False, dev))
        elif zeros:
            pieces.append(torch.zeros_like(t.narrow(dim, 0, r)))
        fmt = CL if t.dim() == 4 and t.is_contiguous(memory_format=CL) \
            and not t.is_contiguous() else torch.contiguous_format
        out.append(torch.cat(pieces, dim).contiguous(memory_format=fmt))
    return out


def _crop(outs: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
          r: int, dim: int) -> List[torch.Tensor]:
    """Each haloed slab's output without its halo rows' (``r`` after a
    neighbour on either side), dense."""
    return [y.narrow(dim, r if i > 0 else 0, t.shape[dim]).contiguous()
            if len(parts) > 1 else y
            for i, (y, t) in enumerate(zip(outs, parts))]


def _rows(x: Slabs, stride: int, dim: int, what: str) -> None:
    for t in x.parts:
        if t.shape[dim] % stride:
            raise ValueError(f"{what}: a slab of {t.shape[dim]} rows is no "
                             f"multiple of the stride {stride}; shard in "
                             "units of the model's downsampling factor")


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1):
    if isinstance(padding, str) or _pair(dilation)[0] != 1 or \
            weight.shape[2] != 2 * _pair(padding)[0] + 1:
        raise NotImplementedError("a spatially sharded conv2d takes odd "
                                  "kernels with (k - 1) / 2 rows of "
                                  "padding and no dilation")
    ph, pw = _pair(padding)
    _rows(input, _pair(stride)[0], 2, "conv2d")
    if ph:
        input = Slabs(halo(input.parts, ph, 2, zeros=True), input.weights)
    return _each(F.conv2d, (input, weight, bias, stride, (0, pw), dilation,
                            groups), {})


def _max_pool2d(input, kernel_size, stride=None, padding=0, dilation=1,
                ceil_mode=False, return_indices=False):
    k = _pair(kernel_size)[0]
    if _pair(stride if stride else kernel_size)[0] != k or \
            _pair(padding)[0] or _pair(dilation)[0] != 1:
        raise NotImplementedError("a spatially sharded max-pool takes "
                                  "windows that do not overlap")
    _rows(input, k, 2, "max_pool2d")
    return _each(F.max_pool2d, (input, kernel_size, stride, padding,
                                dilation, ceil_mode, return_indices), {})


def _res_block_eval(x4d, p, stats, *, dtype=torch.bfloat16):
    w = x4d.weights
    outs = [rk.res_block_eval(h, _part(p, 0, h.device, w),
                              _part(stats, 0, h.device, w), dtype=dtype)
            for h in halo(x4d.parts, 1, 1, zeros=False)]
    return Slabs(_crop(outs, x4d.parts, 1, 1), w)


def _slab_scales(amaxes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The (B,) scale each slab quantises with: the whole sample's
    (``int8.slab_scale``), on each slab's device."""
    scale = int8.slab_scale(amaxes)
    return [scale.to(a.device) for a in amaxes]


def _int8_conv2d(conv, x, dtype):
    xs = [t.permute(0, 2, 3, 1) for t in x.parts]  # NHWC
    scales = _slab_scales([int8.activation_amax(t) for t in xs])
    r = (conv.kernel_size[0] - 1) // 2
    prepared = int8.prepared_kernel(conv)
    outs = [int8.int8_conv(h, prepared=x.weights.kernel(conv, prepared,
                                                        h.device),
                           out_dtype=dtype, scale=s)
            for h, s in zip(halo(xs, r, 1, zeros=False), scales)]
    return Slabs([y.permute(0, 3, 1, 2) for y in _crop(outs, xs, r, 1)],
                 x.weights)


_RULES = {F.conv2d: _conv2d, F.max_pool2d: _max_pool2d,
          rk.res_block_eval: _res_block_eval, int8.conv2d: _int8_conv2d}


def downsampling_factor(model) -> int:
    """Input rows per row at the hourglass waist: ``2^(2 + depth)``."""
    hg = model.hgArray[0] if hasattr(model, "hgArray") else \
        model.hourglass[0]
    return 2 ** (2 + hg.depth)


def make_spatial_fn(model, mesh):
    """The reusable spatially sharded eval forward of a detector
    (``MainModel``, standard, fused or int8, or ``StackedHourglass``,
    standard or int8): ``fn(images (B, H, W, 3)) -> (S, B, H/4, W/4, J)``
    f32 heatmaps on the mesh's first device, as ``model(images)``. The H
    axis is split over ``mesh`` (a ``LocalMesh`` or a list of devices) in
    blocks of whole units of ``downsampling_factor(model)``; the model is
    moved to the mesh's first device and its weights copied once to each
    other device (``Weights``). A model in train mode, or a mesh of the
    CPU and cards, is refused: the JAX package has no such path."""
    if not model.spatial_sharding:
        raise ValueError(f"the {model.variant!r} variant has no spatially "
                         "sharded forward")
    mesh = as_local_mesh(mesh)
    if len({d.type for d in mesh.devices}) > 1:
        raise ValueError("a spatial mesh is all cards or all the CPU: the "
                         "torch7 BN picks its formulation by the device")
    unit = downsampling_factor(model)
    model.to(mesh.devices[0])
    weights = Weights(model, mesh.devices)

    def fn(images) -> torch.Tensor:
        if model.training:
            raise ValueError("spatial sharding runs the eval forward only; "
                             "call model.eval() first")
        weights.refresh()
        slabs = Slabs(shard_spatial(mesh, images, axis=1, unit=unit),
                      weights)
        with torch.no_grad():
            out = model(slabs)
        return gather_spatial(out.parts, axis=2)

    return fn


def spatial_forward(model, images, mesh) -> torch.Tensor:
    """One call of ``make_spatial_fn``. Equals ``model(images)`` in eval
    mode."""
    return make_spatial_fn(model, mesh)(images)
