"""HRNet's eval epilogue of a convolution (kernel K8; a port kernel with no
Pallas counterpart: the JAX package has no HRNet).

``conv_epilogue(terms, relu, out_dtype)`` sums 1-4 terms over the first
term's (B, C, H, W) grid, in their order, then applies an optional ReLU.
A term is ``(x, affine)``: ``x`` a (B, C, H / 2^m, W / 2^m) activation
(m <= 3, read at (h >> m, w >> m): nearest upsampling by 2^m, with no
upsampled tensor written), ``affine`` None or an f32 (2, C) table of the
eval BN's (scale, shift) that ``x`` goes through first. Its rounding
points are those of the composition it replaces (``hourglass_torch7.
bn_in`` on a conv's output, then the adds, ``F.interpolate`` and
``torch.relu`` in the element type):

    t = round(f32(x) * scale + shift)     # a term with an affine
    acc = t_0;  acc = round(acc + t_k)    # k = 1 .. n-1
    out = relu(acc)                       # relu=True

``round`` is to the terms' type (bf16, or f32 where it is a no-op); the
output is that type, or f32 (``out_dtype``). Only the f32 formulation of
BN (a scale and a shift against cuDNN's or the CPU's own) may flip a rare
last bf16 bit.

On a CUDA tensor it launches ``csrc/conv_epilogue.cu`` (bf16 or f32 terms
in ``torch.channels_last``, C a multiple of 8, on the current stream, no
synchronisation); on a CPU tensor it runs ``conv_epilogue_ref``, the plain
PyTorch version. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bilinear_tpu_torch.ops import _build

CL = torch.channels_last
MAX_TERMS = 4
MAX_STEP = 3      # the largest m: upsampling by 8
VEC = 8           # channels a thread of the kernel owns
_TYPES = (torch.bfloat16, torch.float32)

# Calls that went through the CUDA kernel (one launch each).
LAUNCHES = 0

Term = Tuple[torch.Tensor, Optional[torch.Tensor]]


def conv_epilogue(terms: Sequence[Term], relu: bool = False,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The ReLU (``relu``) of the terms' sum, at the first term's
    resolution, in ``out_dtype`` (None: the terms' type)."""
    x0 = terms[0][0]
    if x0.device.type == "cpu":
        return conv_epilogue_ref(terms, relu, out_dtype)
    return _launch(terms, relu, out_dtype)


@torch.no_grad()
def bn_affine(bn, dtype=torch.float32) -> torch.Tensor:
    """An eval BN as a (2, C) table in ``dtype``: scale = gamma *
    rsqrt(var + eps), shift = beta - mean * scale."""
    var, mean = bn.running_var.to(dtype), bn.running_mean.to(dtype)
    scale = bn.weight.to(dtype) * torch.rsqrt(var + bn.eps)
    return torch.stack([scale, bn.bias.to(dtype) - mean * scale])


def conv_epilogue_ref(terms: Sequence[Term], relu: bool = False,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The plain PyTorch version, on any device: each affine in its
    table's type, rounded to the term's; the adds, upsampling and ReLU in
    the terms' type."""
    acc = None
    for x, affine in terms:
        if affine is not None:
            shape = (1, -1, 1, 1)
            x = (x.to(affine.dtype) * affine[0].view(shape)
                 + affine[1].view(shape)).to(x.dtype)
        if acc is not None and x.shape[-1] != acc.shape[-1]:
            x = F.interpolate(x, scale_factor=acc.shape[-1] // x.shape[-1],
                              mode="nearest")
        acc = x if acc is None else acc + x
    if relu:
        acc = torch.relu(acc)
    if out_dtype is not None:
        acc = acc.to(out_dtype)
    return acc.contiguous(memory_format=CL)


_fn = None


def _lib():
    global _fn
    if _fn is None:
        fn = _build.library("conv_epilogue").conv_epilogue_forward
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(terms: Sequence[Term], relu: bool,
            out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The C entry on the current stream. Lean on the host: HRNet makes
    262 calls a forward, and beyond ~20 us a call the host, not the card,
    sets the pace of a served chunk."""
    global LAUNCHES
    x0 = terms[0][0]
    b, c, h, w = x0.shape
    dt = x0.dtype
    dev = x0.get_device()
    f32_out = out_dtype is not None and out_dtype != dt
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"the kernel sums 1 to {MAX_TERMS} terms, got "
                         f"{len(terms)}")
    if dt not in _TYPES or f32_out and out_dtype != torch.float32:
        raise ValueError(f"the kernel takes bf16 or f32 terms and writes "
                         f"their type or f32, got {dt} -> {out_dtype}")
    if c % VEC or b * h * w * c >= 2 ** 31:
        raise ValueError(f"(B, C, H, W) = {tuple(x0.shape)}: the kernel "
                         f"takes a multiple of {VEC} channels and fewer "
                         f"than 2^31 elements")
    ptrs = [0] * (2 * MAX_TERMS)
    flags = len(terms) | relu << 3 | f32_out << 4 | \
        (dt == torch.float32) << 5 | dev << 16
    for k, (x, affine) in enumerate(terms):
        m = (h // x.shape[2]).bit_length() - 1
        ptr = ptrs[k] = x.data_ptr()
        if (x.dtype != dt or not 0 <= m <= MAX_STEP
                or x.shape != (b, c, h >> m, w >> m)
                or h >> m << m != h or w >> m << m != w
                or x.get_device() != dev
                or not x.is_contiguous(memory_format=CL) or ptr % 16):
            raise ValueError(
                f"term {k}: {dt} (B, C, H, W) = {tuple(x.shape)} in "
                f"channels_last at a 16-byte aligned address on cuda:{dev}, "
                f"with H, W the output's {h}, {w} over 2^m, m <= "
                f"{MAX_STEP}; got {x.dtype} {tuple(x.shape)}")
        flags |= m << (8 + 2 * k)
        if affine is None:
            continue
        ptr = ptrs[MAX_TERMS + k] = affine.data_ptr()
        if (affine.dtype != torch.float32 or affine.shape != (2, c)
                or affine.get_device() != dev or not affine.is_contiguous()
                or ptr % 16):
            raise ValueError(f"term {k}: the affine must be a contiguous, "
                             f"16-byte aligned float32 (2, {c}) table on "
                             f"cuda:{dev}")
    # x0 is channels_last-contiguous, and so is its like.
    out = torch.empty_like(x0, dtype=out_dtype)
    # The raw stream handle: torch.cuda.current_stream(dev).cuda_stream
    # builds a Stream object first, 2 us of host time a call.
    rc = _lib()(out.data_ptr(), *ptrs, b, h, w, c, flags,
                torch._C._cuda_getCurrentRawStream(dev))
    _build.check(rc, "conv_epilogue_forward")
    LAUNCHES += 1
    return out
