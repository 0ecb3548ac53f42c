"""Lifting forward (kernel K1): the whole ``BilinearUnit`` eval forward, BN
folded into each Linear, dropout as the identity (counterpart of
``bilinear_tpu/ops/pallas/lifting.py``).

``lifting_forward`` takes the JAX package's ``{params, batch_stats}`` tree
(numpy or tensors). On a CUDA tensor it launches ``csrc/lifting.cu``; on a
CPU tensor it runs ``lifting_forward_ref``, the plain PyTorch version of
the same arithmetic. There is no fallback from one to the other.

The kernel has two paths, chosen by row count in ``choose_path``: one
cooperative launch that runs all six layers (a serving batch), or one
``wgmma`` GEMM launch per layer (bulk batches; the f32 mode always, with a
SIMT GEMM). From ``PERSISTENT_MIN_ROWS`` bf16 rows up, the per-layer
path runs the encode and the four hidden layers in a persistent,
warp-specialised TMA kernel (``choose_route``: "persistent"). Every route
gives the same bits for a row.

Numerics (the TPU kernel's): matmuls accumulate in f32; each
``dense_relu`` output and each residual sum is rounded to the working type;
the decode output is f32. Rows are independent, so nothing is padded.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from bilinear_tpu_torch.device import resolve_device
from bilinear_tpu_torch.ops import _build

HIDDEN = 1024
IN_F = 32
OUT_F = 48
LAYER_NAMES = ["encode", "bilinear_0_0", "bilinear_0_1", "bilinear_1_0",
               "bilinear_1_1"]

# Forwards that went through the CUDA kernels (one per call of the C entry,
# which launches the one serving kernel or the six layer kernels).
LAUNCHES = 0
# The same calls by route (choose_route).
ROUTE_CALLS = {"fused": 0, "layers": 0, "persistent": 0}

# The kernel's paths. "fused": one cooperative launch for all six layers;
# "layers": one launch per layer; "empty": nothing to launch.
PATHS = ("empty", "fused", "layers")
# Largest row count the one-launch kernel takes: up to here it measured
# faster on an H100 than six launches (chip_smoke.py prints both sides).
FUSED_MAX_ROWS = 1024


def choose_path(n: int, fused_ok: bool = True) -> str:
    """The kernel path for ``n`` rows, one of ``PATHS``. ``fused_ok`` is
    False where no one-launch kernel exists (the f32 mode)."""
    if n <= 0:
        return "empty"
    if fused_ok and n <= FUSED_MAX_ROWS:
        return "fused"
    return "layers"


# K1's routes: the paths, with bf16's per-layer path split by the kernel
# its encode and hidden layers run in ("layers": the per-layer wgmma GEMM;
# "persistent": the persistent TMA kernel, bf16 only).
ROUTES = PATHS + ("persistent",)
# Fewest rows the persistent kernel takes: at 2,048 rows the per-layer GEMM
# measured faster on an H100 (its 128 x 128 tiles fill the SMs, the
# persistent kernel's 128 x 256 tiles half of them), from 2,049 up slower
# (chip_smoke.py times both).
PERSISTENT_MIN_ROWS = 2049


def choose_route(n: int, dtype: torch.dtype) -> str:
    """The kernel route for ``n`` rows in ``dtype``, one of ``ROUTES``."""
    bf16 = dtype == torch.bfloat16
    path = choose_path(n, fused_ok=bf16)
    if path == "layers" and bf16 and n >= PERSISTENT_MIN_ROWS:
        return "persistent"
    return path


class Prepared(list):
    """Six (kernel (in, out) in the working type, bias f32) pairs, as the
    plain version and the f32 kernel read them. ``kmajor`` holds the
    K-contiguous (out, in) copy of each kernel that the bf16 ``wgmma``
    kernels read (None for f32 weights). ``checked`` is the wrapper's
    note of the tensors it has validated (``check_if_changed``)."""

    kmajor: Optional[List[torch.Tensor]] = None
    checked: Optional[Tuple] = None


def _f32(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):  # copy: the leaf may be read-only
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32)


def fold_bn(kernel, bias, bn: Mapping[str, Any], eps: float = 1e-5):
    """Fold torch-semantics eval BN into the preceding Linear:
    ``BN(xW + b) == x (W s) + (b s + t)``, ``s = scale / sqrt(var + eps)``,
    ``t = bias - mean s``. ``kernel`` is (in, out)."""
    s = bn["scale"] / torch.sqrt(bn["var"] + eps)
    t = bn["bias"] - bn["mean"] * s
    return kernel * s[None, :], bias * s + t


def folded_layer(params, batch_stats, name: str, device):
    """The BN-folded (kernel (in, out), bias) of one HeavyLinear, f32."""
    p, st = params[name], batch_stats[name]["bn"]
    bn = {
        "scale": _f32(p["bn"]["scale"], device),
        "bias": _f32(p["bn"]["bias"], device),
        "mean": _f32(st["mean"], device),
        "var": _f32(st["var"], device),
    }
    return fold_bn(_f32(p["linear"]["kernel"], device),
                   _f32(p["linear"]["bias"], device), bn)


def prepare_weights(params, batch_stats, dtype=torch.bfloat16,
                    device=None) -> Prepared:
    """Fold BN and cast, once per checkpoint: six (kernel (in, out) in
    ``dtype``, bias f32) pairs on ``device`` (default: the card) and, for
    bf16, their (out, in) copies."""
    device = resolve_device(device)
    weights = Prepared()
    for name in LAYER_NAMES:
        k, b = folded_layer(params, batch_stats, name, device)
        weights.append((k.to(dtype).contiguous(), b.contiguous()))
    weights.append((
        _f32(params["decode"]["kernel"], device).to(dtype).contiguous(),
        _f32(params["decode"]["bias"], device).contiguous(),
    ))
    if dtype == torch.bfloat16:
        weights.kmajor = [w.t().contiguous() for w, _ in weights]
    return weights


def lifting_forward_ref(weights: Prepared, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (n, 32) -> (n, 48) f32. Products
    of working-type values are exact in f32, so an f32 matmul of the
    upcast operands is the f32-accumulated product."""
    dtype = weights[0][0].dtype

    def dense(h, w, b):
        return h.float() @ w.float() + b

    def dense_relu(h, w, b):
        return torch.relu(dense(h, w, b)).to(dtype)

    h = dense_relu(x.to(dtype), *weights[0])
    for blk in range(2):
        skip = h
        h = dense_relu(h, *weights[1 + 2 * blk])
        h = dense_relu(h, *weights[2 + 2 * blk])
        h = (h.float() + skip.float()).to(dtype)
    return dense(h, *weights[5])


def rows_for_kernel(x: torch.Tensor) -> torch.Tensor:
    """Contiguous rows at a 16-byte aligned address (the kernels load 16
    bytes at a time); a view at an unaligned offset is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 2
             + [ctypes.c_void_p])


_fn = None


def _lib():
    global _fn
    if _fn is None:
        fn = _build.library("lifting").lifting_forward
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def on_device(device: torch.device):
    """Context that makes ``device`` current for a launch; free when it
    already is."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_if_changed(holder, tensors: Sequence[torch.Tensor], key,
                     check: Callable[[], None]) -> None:
    """Run ``check()``, which validates ``tensors``, unless it passed at the
    last call with this ``key`` and each tensor is still the very object at
    the very address (``holder.checked`` keeps those objects, so none can
    have been freed and its identity reused). A ``holder`` without that
    attribute (a plain list or dict) is checked at every call."""
    ptrs = [t.data_ptr() for t in tensors]
    seen = getattr(holder, "checked", None)
    if (seen is not None and seen[0] == key and seen[2] == ptrs
            and len(seen[1]) == len(tensors)
            and all(a is b for a, b in zip(seen[1], tensors))):
        return
    check()
    if hasattr(type(holder), "checked"):
        holder.checked = (key, tuple(tensors), ptrs)


def _weight_pointers(weights: Prepared, x: torch.Tensor) -> List[int]:
    """Addresses of the six (kernel, bias) pairs as the kernel reads them,
    validated against ``x``."""
    bf16 = x.dtype == torch.bfloat16
    kmajor = getattr(weights, "kmajor", None) if bf16 else None
    if bf16 and (kmajor is None or len(kmajor) != 6):
        raise ValueError("bf16 weights need their K-contiguous copies: "
                         "make them with prepare_weights")
    read, seen = [], []
    for i, (w, b) in enumerate(weights):
        read += [kmajor[i] if bf16 else w, b]
        seen += [w, b] + ([kmajor[i]] if bf16 else [])
    check_if_changed(weights, seen, (x.dtype, x.device),
                     lambda: _check_weights(weights, x))
    return [t.data_ptr() for t in read]


def _check_weights(weights: Prepared, x: torch.Tensor) -> None:
    dims = [(IN_F, HIDDEN)] + [(HIDDEN, HIDDEN)] * 4 + [(HIDDEN, OUT_F)]
    for (w, b), (k, n) in zip(weights, dims):
        if w.shape != (k, n) or b.shape != (n,):
            raise ValueError(f"weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)}, expected ({k}, {n})")
        if w.dtype != x.dtype or b.dtype != torch.float32:
            raise ValueError("weights must be in the working type, biases f32")
        if w.device != x.device or b.device != x.device:
            raise ValueError("weights and rows must be on the same device")
        if not (w.is_contiguous() and b.is_contiguous()) or w.data_ptr() % 16:
            raise ValueError("weights must be contiguous and 16-byte aligned")
    if x.dtype == torch.bfloat16:
        for (w, _), wt in zip(weights, weights.kmajor):
            if (wt.shape != w.t().shape or wt.dtype != w.dtype
                    or wt.device != w.device or not wt.is_contiguous()
                    or wt.data_ptr() % 16):
                raise ValueError("a K-contiguous weight copy does not match "
                                 "its weight")


# The C entry's number for each route.
_ROUTE_ARG = {"layers": 0, "fused": 1, "persistent": 2}


def lifting_forward_cuda(weights: Prepared, x: torch.Tensor,
                         path: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel on the current stream. ``x``: (n, 32) CUDA tensor
    in the weights' type (bf16 or f32). ``path`` (a route: "fused",
    "layers" or "persistent") overrides ``choose_route``, to time both
    sides of a boundary."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError("lifting_forward_cuda needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {x.dtype}")
    if x.dim() != 2 or x.shape[1] != IN_F:
        raise ValueError(f"x must be (n, {IN_F}), got {tuple(x.shape)}")
    x = rows_for_kernel(x)
    weight_ptrs = _weight_pointers(weights, x)
    n = x.shape[0]
    out = torch.empty((n, OUT_F), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    if path is None:
        path = choose_route(n, x.dtype)
    if path not in _ROUTE_ARG or (path != "layers" and not bf16):
        raise ValueError(f"no kernel path {path!r} for {x.dtype}")
    scratch = torch.empty((3, n, HIDDEN), dtype=x.dtype, device=x.device)
    h0 = scratch.data_ptr()
    step = n * HIDDEN * scratch.element_size()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with on_device(x.device):
        rc = _lib()(int(bf16), x.data_ptr(), *weight_ptrs, out.data_ptr(),
                    h0, h0 + step, h0 + 2 * step, n, _ROUTE_ARG[path],
                    stream)
    _build.check(rc, "lifting_forward")
    LAUNCHES += 1
    ROUTE_CALLS[path] += 1
    return out


def lifting_forward(params, batch_stats, x: torch.Tensor,
                    dtype=torch.bfloat16,
                    prepared: Optional[Prepared] = None) -> torch.Tensor:
    """Eval-mode forward, (n, 32) -> (n, 48) f32, on ``x``'s device. Pass
    ``prepared=prepare_weights(...)`` to fold BN once per checkpoint."""
    weights = prepared if prepared is not None else prepare_weights(
        params, batch_stats, dtype, device=x.device
    )
    x = x.to(weights[0][0].dtype)
    if x.device.type == "cpu":
        return lifting_forward_ref(weights, x)
    return lifting_forward_cuda(weights, x)
