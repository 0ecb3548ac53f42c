"""Dynamic int8 convolutions of the detectors' eval path (counterpart of
``bilinear_tpu/ops/int8.py``), with kernels K6 and K7
(``csrc/int8_conv.cu``).

The JAX package's scheme, to the letter:
- weights: symmetric per-output-channel int8,
  ``s_j = max(max|k[..., j]|, 1e-12) / 127``, ``kq = clip(round(k / s), -127,
  127)``, quantized from the f32 parameters;
- activations: symmetric per-SAMPLE int8 over (H, W, C), the same formula;
  ``round`` is half-to-even and both divisions are true divisions;
- ``acc`` = int8 x int8 -> int32, stride 1, padding (k - 1) // 2;
- ``y = acc.f32 * (s_x * s_w)`` (the product of the scales formed first),
  then ``+ bias`` in f32, then cast to the input's dtype.
With that order ``kq``, ``xq`` and the scales are JAX's bit for bit on equal
f32 inputs.

Public functions keep the JAX layouts: NHWC activations, HWIO kernels.
``quantize_conv_kernel`` is plain PyTorch on either device (once per loaded
model: ``conv2d`` keeps its result on the conv module and quantizes again
when the weights change). On a CUDA tensor ``quantize_activations``
launches K6, ``int8_conv_cuda`` K7, and ``int8_conv`` both in one call
(``int8_conv_fused_cuda``); on a CPU tensor they run the plain versions
(``*_ref``). There is no fallback. K7's route, tile and split of K come
from ``plan_conv``, a pure function of the shape (the CPU tests check its
plans; ``split_accumulators_ref`` is the plain version of a split).

The plain versions never convolve int8 with ``F.conv2d`` (on the CPU it
returns int8 and wraps) nor in f32 (a torch7 3x3 has K = 1,152, and
1,152 * 127^2 > 2^24, so f32 partial sums need not be exact): the int32
accumulator is a float64 convolution of the int8 values, exact because
|acc| <= 9 * 256 * 127^2 < 2^53.

A tensor cut into row slabs (``parallel/spatial.py``) must quantise every
slab with the whole sample's scale. K6 then runs as two stage entries:
``activation_amax`` (each sample's max|x| over a slab), ``slab_scale`` (the
maximum over the slabs, exact in any order, and the scale by JAX's formula
with a true division), ``quantize_scaled`` (int8 with that scale); the
slabs put back together are ``quantize_activations_ref``'s bits.
``int8_conv(..., scale=)`` takes the scale and launches the second stage
and K7. Unsharded paths keep the one launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function_unary

from bilinear_tpu_torch.ops import _build
from bilinear_tpu_torch.ops.lifting import on_device

# The detectors' quantize modes (``quantize=`` of the models, End2End and
# End2EndServer).
MODES = (None, "int8")

# Launches of the kernels, whichever entry made them: K6, K7.
LAUNCHES_QUANTIZE = 0
LAUNCHES_CONV = 0
# Launches of K6's two stage entries (amax, quantise with a given scale),
# one each; not counted in LAUNCHES_QUANTIZE.
LAUNCHES_QUANTIZE_STAGES = 0

OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


class QuantizedKernel(NamedTuple):
    """A conv's prepared weights: ``kq`` int8 (Co, kh, kw, Ci) contiguous
    (the K-contiguous rows K7 reads; ``kq.permute(1, 2, 3, 0)`` is JAX's
    HWIO), ``scale`` f32 (Co,), ``bias`` f32 (Co,) or None."""

    kq: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor]


def _div127(a: torch.Tensor) -> torch.Tensor:
    """``a / 127`` as a true division (torch multiplies a CUDA tensor by the
    reciprocal of a Python scalar divisor)."""
    return a / a.new_tensor(127.0)


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_conv_kernel(kernel: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an HWIO kernel: (kq int8 (kh, kw,
    ci, co), scale f32 (co,))."""
    kf = kernel.float()
    scale = _div127(torch.clamp_min(kf.abs().amax(dim=(0, 1, 2)), 1e-12))
    return _quantize(kf, scale), scale


def prepare_kernel(kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> QuantizedKernel:
    """An HWIO kernel (and its bias) in the form ``int8_conv`` takes."""
    kq, scale = quantize_conv_kernel(kernel)
    return QuantizedKernel(
        kq.permute(3, 0, 1, 2).contiguous(), scale.contiguous(),
        None if bias is None else bias.float().contiguous())


def quantize_activations_ref(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: (xq int8 like ``x``, scale f32 (B, 1, 1, 1)),
    the plain versions of its two stages on one slab."""
    scale = slab_scale([activation_amax_ref(x)])
    return quantize_scaled_ref(x, scale), scale.reshape(-1, 1, 1, 1)


def activation_amax_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K6's first stage: each sample's max|x|, (B,) f32."""
    return x.float().abs().amax(dim=(1, 2, 3))


def slab_scale(amaxes) -> torch.Tensor:
    """The per-sample scale of a tensor cut into slabs, from each slab's
    ``activation_amax`` (on the first one's device): (B,) f32,
    ``max(amax, 1e-12) / 127`` of the maximum over the slabs."""
    dev = amaxes[0].device
    amax = amaxes[0]
    for a in amaxes[1:]:
        amax = torch.maximum(amax, a.to(dev))
    return _div127(torch.clamp_min(amax, 1e-12))


def quantize_scaled_ref(x: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version of K6's second stage: int8 like ``x`` with the given
    (B,) f32 scale."""
    return _quantize(x.float(), scale.reshape(-1, 1, 1, 1))


def int8_conv_acc_ref(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """The exact int32 accumulator of NHWC int8 ``xq`` and (Co, kh, kw, Ci)
    int8 ``kq``, stride 1, padding (k - 1) // 2: a float64 convolution of
    the int8 values (exact below 2^53), as a contiguous NHWC tensor, the
    layout K7 writes (the float ops after a conv pick their kernels, and so
    their rounding, by the layout they are given)."""
    k = kq.shape[1]
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   kq.permute(0, 3, 1, 2).double(), padding=(k - 1) // 2)
    return acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def dequantize_ref(acc: torch.Tensor, sx: torch.Tensor,
                   prepared: QuantizedKernel, out_dtype) -> torch.Tensor:
    """JAX's epilogue: ``acc.f32 * (sx * ks)``, then ``+ bias`` (f32), then
    the cast; ``sx`` (B, 1, 1, 1)."""
    y = acc.float() * (sx.reshape(-1, 1, 1, 1) * prepared.scale)
    if prepared.bias is not None:
        y = y + prepared.bias
    return y.to(out_dtype)


def int8_conv_ref(x: torch.Tensor, kernel: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None, *,
                  prepared: Optional[QuantizedKernel] = None,
                  out_dtype=None, scale: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Plain version of ``int8_conv`` (``scale`` as there)."""
    if prepared is None:
        prepared = prepare_kernel(kernel, bias)
    if scale is None:
        xq, sx = quantize_activations_ref(x)
    else:
        xq, sx = quantize_scaled_ref(x, scale), scale
    return dequantize_ref(int8_conv_acc_ref(xq, prepared.kq), sx, prepared,
                          out_dtype or x.dtype)


# ------------------------------------------------------------------- plans

# K7's tiles, as csrc/int8_conv.cu instantiates them: (output channels per
# block, stages of the shared-memory ring) -> blocks to an SM. A block is
# CONV_BM output pixels (two warpgroups of 64 rows).
TILES = {(64, 4): 2, (128, 3): 2}
CONV_BM = 128
SLAB = 128  # bytes of K per ring stage: one 128-byte swizzled row
SMS = 132  # streaming multiprocessors of an H100 SXM: one wave of blocks
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper
ROUTES = ("wgmma", "wgmma_splitk")
# Split-K where the output tiles fill at most half a wave of SMs and K has
# at least SPLIT_MIN_SLABS slabs: a fuller grid, or fewer slabs, lost more
# to the reduction than the splits won. A tile's splits are one thread-block
# cluster: at most MAX_SPLITS (csrc/int8_conv.cu), the largest portable one.
SPLIT_MIN_SLABS = 3
MAX_SPLITS = 8
# K6's tile (csrc/int8_conv.cu Q_TILE x 8): one max|x| slot per tile.
QUANT_TILE = 8192


class ConvPlan(NamedTuple):
    """How K7 runs one shape: ``route`` (one of ``ROUTES``), the tile's
    output channels ``bn`` and ring ``depth``, and K cut into ``splits``
    runs of ``per`` consecutive 128-byte slabs (``slabs`` in all); a grid
    of ``m_tiles`` x ``n_tiles`` output tiles, ``splits`` blocks each."""

    route: str
    bn: int
    depth: int
    splits: int
    per: int
    slabs: int
    m_tiles: int
    n_tiles: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    @property
    def smem(self) -> int:
        """Dynamic shared memory of a block: the ring, 1024-byte aligned."""
        return 1024 + self.depth * SLAB * (CONV_BM + self.bn)

    def k_ranges(self, kbytes: int) -> List[Tuple[int, int]]:
        """The [start, end) bytes of K (= k * k * Ci) each split sums."""
        return [(min(s * self.per * SLAB, kbytes),
                 min((s + 1) * self.per * SLAB, kbytes))
                for s in range(self.splits)]


def default_tile(m: int, co: int) -> Tuple[int, int]:
    """(bn, depth) for m output pixels and co channels: 128-wide tiles
    where they fill a wave, else 64-wide ones, which spread a small grid
    over more SMs (a 256-wide tile, all of a 256-channel conv in one block,
    lost to two 128-wide ones at every served shape)."""
    tiles128 = -(-m // CONV_BM) * -(-co // 128)
    return (128, 3) if co > 64 and tiles128 >= SMS else (64, 4)


@functools.lru_cache(maxsize=4096)
def plan_conv(b: int, h: int, w: int, ci: int, co: int, k: int,
              route: Optional[str] = None, bn: Optional[int] = None,
              depth: Optional[int] = None) -> ConvPlan:
    """K7's plan for x (b, h, w, ci) and a (co, k, k, ci) kernel: the tile
    of ``default_tile``; split-K where the output tiles fill at most half a
    wave of the card's SMs and K has at least SPLIT_MIN_SLABS slabs, in as
    many splits (at most MAX_SPLITS) as bring the grid to about one wave,
    each of whole slabs. ``route``, ``bn`` and ``depth`` force a choice (the
    checks run every route and tile at shapes where it is not the default);
    a forced split route splits at least in two."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"int8_conv: no route {route!r}, only {ROUTES}")
    m = b * h * w
    if bn is None and depth is None:
        bn, depth = default_tile(m, co)
    if (bn, depth) not in TILES:
        raise ValueError(f"int8_conv: no tile ({bn}, {depth}); "
                         f"instantiated: {sorted(TILES)}")
    slabs = -(-k * k * ci // SLAB)
    m_tiles, n_tiles = -(-m // CONV_BM), -(-co // bn)
    tiles = m_tiles * n_tiles
    if route is None:
        route = "wgmma_splitk" if 2 * tiles <= SMS and \
            slabs >= SPLIT_MIN_SLABS else "wgmma"
    if route == "wgmma":
        return ConvPlan(route, bn, depth, 1, slabs, slabs, m_tiles, n_tiles)
    if slabs < 2:
        raise ValueError(f"int8_conv: K = {k * k * ci} bytes is one slab; "
                         "it cannot be split")
    want = min(slabs, MAX_SPLITS, max(2, SMS // tiles))
    per = -(-slabs // want)
    return ConvPlan(route, bn, depth, -(-slabs // per), per, slabs, m_tiles,
                    n_tiles)


def split_accumulators_ref(xq: torch.Tensor, kq: torch.Tensor,
                           plan: ConvPlan) -> List[torch.Tensor]:
    """Plain version of what each split of ``plan`` sums: the int32
    accumulator of ``xq`` with ``kq`` restricted to the split's range of K
    (the (tap, channel) pairs of its slabs). Their sum is
    ``int8_conv_acc_ref(xq, kq)``."""
    co = kq.shape[0]
    flat = kq.reshape(co, -1)
    out = []
    for lo, hi in plan.k_ranges(flat.shape[1]):
        part = torch.zeros_like(flat)
        part[:, lo:hi] = flat[:, lo:hi]
        out.append(int8_conv_acc_ref(xq, part.reshape(kq.shape)))
    return out


# ------------------------------------------------------------------ kernels

_fns = None


def _lib():
    global _fns
    if _fns is None:
        lib = _build.library("int8_conv")
        q = lib.int8_quantize_activations
        q.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong] + [ctypes.c_void_p] * 4
        q.restype = ctypes.c_int
        c = lib.int8_conv_forward
        c.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        c.restype = ctypes.c_int
        f = lib.int8_conv_fused
        f.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        a = lib.int8_activation_amax
        a.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong] + [ctypes.c_void_p] * 3
        a.restype = ctypes.c_int
        s = lib.int8_quantize_scaled
        s.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong] + [ctypes.c_void_p] * 3
        s.restype = ctypes.c_int
        _fns = (q, c, f, a, s)
    return _fns


def _nhwc_for_kernel(x: torch.Tensor, dtypes, what: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor")
    if x.dim() != 4 or x.dtype not in dtypes:
        raise ValueError(f"{what}: x must be a 4-d NHWC tensor of "
                         f"{dtypes}, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_conv(shape, device, prepared: QuantizedKernel, out_dtype,
                sx: Optional[torch.Tensor] = None) -> None:
    """Refuse what K7 does not take: the kernel against x's shape, the
    operands' types, devices and layouts, the output type."""
    kq, ks, bias = prepared
    b, h, w, ci = shape
    co, kh, kw, kci = kq.shape
    if out_dtype not in OUT_KINDS:
        raise ValueError(f"int8_conv: no output type {out_dtype}")
    if kh != kw or kh % 2 == 0 or kci != ci:
        raise ValueError(f"int8_conv: kernel {tuple(kq.shape)} does not fit "
                         f"x {tuple(shape)} (odd square kernels only)")
    if ci % 64 or co % 16:
        raise ValueError("int8_conv: Ci must be a multiple of 64 and Co of "
                         f"16, got Ci={ci}, Co={co}")
    if b * h * w * max(ci, co) >= 2 ** 31:
        raise ValueError("int8_conv: B * H * W * C must be below 2^31")
    tensors = [kq, ks] + ([] if bias is None else [bias])
    if sx is not None:
        tensors.append(sx)
        if sx.numel() != b or sx.dtype != torch.float32:
            raise ValueError("int8_conv: one f32 scale per sample")
    for t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError("int8_conv: operands must be contiguous, on "
                             "x's device")
    if kq.dtype != torch.int8 or kq.data_ptr() % 16:
        raise ValueError("int8_conv: kq must be 16-byte aligned int8")
    if ks.dtype != torch.float32 or ks.shape != (co,) or (
            bias is not None and (bias.dtype != torch.float32
                                  or bias.shape != (co,))):
        raise ValueError("int8_conv: scales and bias must be f32 (Co,)")


def _align(n: int) -> int:
    return -(-n // 256) * 256


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample symmetric int8 of an NHWC tensor: (xq int8, scale f32 (B,
    1, 1, 1)). K6 on a CUDA tensor (f32 or bf16, H * W * C a multiple of
    8), the plain version on a CPU tensor."""
    global LAUNCHES_QUANTIZE
    if x.device.type == "cpu":
        return quantize_activations_ref(x)
    x = _nhwc_for_kernel(x, (torch.float32, torch.bfloat16),
                         "quantize_activations")
    b = x.shape[0]
    per = x[0].numel()
    if per % 8:
        raise ValueError("quantize_activations: H * W * C must be a "
                         "multiple of 8")
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((b, 1, 1, 1), dtype=torch.float32, device=x.device)
    if xq.numel() == 0:
        return xq, scale
    slots = torch.empty((b * -(-per // QUANT_TILE),), dtype=torch.float32,
                        device=x.device)
    with on_device(x.device):
        rc = _lib()[0](x.data_ptr(), int(x.dtype == torch.bfloat16), b, per,
                       xq.data_ptr(), scale.data_ptr(), slots.data_ptr(),
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int8_quantize_activations")
    LAUNCHES_QUANTIZE += 1
    return xq, scale


def _stage_input(x: torch.Tensor, what: str) -> Tuple[torch.Tensor, int]:
    x = _nhwc_for_kernel(x, (torch.float32, torch.bfloat16), what)
    per = x[0].numel() if x.shape[0] else 0
    if per % 8:
        raise ValueError(f"{what}: H * W * C must be a multiple of 8")
    return x, per


def activation_amax(x: torch.Tensor) -> torch.Tensor:
    """K6's first stage: each sample's max|x| over the NHWC slab ``x``,
    (B,) f32. The kernel on a CUDA tensor (f32 or bf16, H * W * C a
    multiple of 8), the plain version on a CPU tensor."""
    global LAUNCHES_QUANTIZE_STAGES
    if x.device.type == "cpu":
        return activation_amax_ref(x)
    x, per = _stage_input(x, "activation_amax")
    b = x.shape[0]
    amax = torch.empty((b,), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return amax.zero_()
    slots = torch.empty((b * -(-per // QUANT_TILE),), dtype=torch.float32,
                        device=x.device)
    with on_device(x.device):
        rc = _lib()[3](x.data_ptr(), int(x.dtype == torch.bfloat16), b, per,
                       amax.data_ptr(), slots.data_ptr(),
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int8_activation_amax")
    LAUNCHES_QUANTIZE_STAGES += 1
    return amax


def quantize_scaled(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K6's second stage: int8 of the NHWC ``x`` with the given (B,) f32
    ``scale`` (``slab_scale``). The kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    global LAUNCHES_QUANTIZE_STAGES
    if x.device.type == "cpu":
        return quantize_scaled_ref(x, scale)
    x, per = _stage_input(x, "quantize_scaled")
    b = x.shape[0]
    if scale.dtype != torch.float32 or scale.numel() != b or \
            scale.device != x.device or not scale.is_contiguous():
        raise ValueError("quantize_scaled: one contiguous f32 scale per "
                         "sample, on x's device")
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if xq.numel() == 0:
        return xq
    with on_device(x.device):
        rc = _lib()[4](x.data_ptr(), int(x.dtype == torch.bfloat16), b, per,
                       scale.data_ptr(), xq.data_ptr(),
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int8_quantize_scaled")
    LAUNCHES_QUANTIZE_STAGES += 1
    return xq


def int8_conv_cuda(xq: torch.Tensor, sx: Optional[torch.Tensor],
                   prepared: QuantizedKernel, out_dtype,
                   plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """K7 on NHWC int8 ``xq`` (CUDA): (B, H, W, Co) in ``out_dtype`` (f32
    or bf16, JAX's epilogue with the per-sample scales ``sx``) or, for
    ``torch.int32``, the raw accumulator (``sx`` unused). ``plan`` (default
    ``plan_conv`` of the shape) is taken as given."""
    global LAUNCHES_CONV
    xq = _nhwc_for_kernel(xq, (torch.int8,), "int8_conv")
    b, h, w, ci = xq.shape
    _check_conv(xq.shape, xq.device, prepared, out_dtype,
                None if out_dtype == torch.int32 else sx)
    kq, ks, bias = prepared
    co, k = kq.shape[0], kq.shape[1]
    out = torch.empty((b, h, w, co), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = plan_conv(b, h, w, ci, co, k)
    with on_device(xq.device):
        rc = _lib()[1](xq.data_ptr(), kq.data_ptr(),
                       None if out_dtype == torch.int32 else sx.data_ptr(),
                       ks.data_ptr(), None if bias is None else
                       bias.data_ptr(), out.data_ptr(), b, h, w, ci, co, k,
                       OUT_KINDS[out_dtype], plan.bn, plan.depth,
                       plan.splits, plan.per,
                       torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(rc, "int8_conv_forward")
    LAUNCHES_CONV += 1
    return out


def int8_conv_fused_cuda(x: torch.Tensor, prepared: QuantizedKernel,
                         out_dtype) -> torch.Tensor:
    """K6 then K7 (through ``plan_conv`` of the shape) on the f32 or bf16
    NHWC ``x`` (CUDA) in one call: the quantized activations, their scales
    and K6's slots live in one scratch allocation; (B, H, W, Co) in
    ``out_dtype``."""
    global LAUNCHES_QUANTIZE, LAUNCHES_CONV
    x = _nhwc_for_kernel(x, (torch.float32, torch.bfloat16), "int8_conv")
    b, h, w, ci = x.shape
    _check_conv(x.shape, x.device, prepared, out_dtype)
    kq, ks, bias = prepared
    co, k = kq.shape[0], kq.shape[1]
    out = torch.empty((b, h, w, co), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = plan_conv(b, h, w, ci, co, k)
    at_sx = _align(b * h * w * ci)
    at_slots = at_sx + _align(4 * b)
    size = at_slots + 4 * b * -(-h * w * ci // QUANT_TILE)
    scratch = torch.empty((size,), dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    with on_device(x.device):
        rc = _lib()[2](x.data_ptr(), int(x.dtype == torch.bfloat16), base,
                       base + at_sx, base + at_slots, kq.data_ptr(),
                       ks.data_ptr(), None if bias is None else
                       bias.data_ptr(), out.data_ptr(), b, h, w, ci, co, k,
                       OUT_KINDS[out_dtype], plan.bn, plan.depth,
                       plan.splits, plan.per,
                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "int8_conv_fused")
    LAUNCHES_QUANTIZE += 1
    LAUNCHES_CONV += 1
    return out


def int8_conv(x: torch.Tensor, kernel: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, *,
              prepared: Optional[QuantizedKernel] = None,
              out_dtype=None, scale: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """The quantized conv at eval time, NHWC x HWIO with padding (k - 1) //
    2 and stride 1: ``x`` and ``kernel`` are the ordinary float tensors
    (or ``prepared=prepare_kernel(kernel, bias)``, quantized once), the
    result is in ``out_dtype`` (default ``x.dtype``). K6 + K7 in one call
    (``int8_conv_fused_cuda``) on a CUDA tensor, the plain version on a CPU
    tensor. With ``scale`` ((B,) f32, ``slab_scale``) ``x`` is quantised
    with it: K6's second stage, then K7."""
    out_dtype = out_dtype or x.dtype
    if prepared is None:
        prepared = prepare_kernel(kernel, bias)
    if x.device.type == "cpu":
        return int8_conv_ref(x, prepared=prepared, out_dtype=out_dtype,
                             scale=scale)
    if scale is not None:
        return int8_conv_cuda(quantize_scaled(x, scale), scale, prepared,
                              out_dtype)
    return int8_conv_fused_cuda(x, prepared, out_dtype)


def prepared_kernel(conv: nn.Conv2d) -> QuantizedKernel:
    """``conv``'s weights in ``int8_conv``'s form, quantized once and kept
    on the module beside the version and address of each; a changed weight
    (a reload copies into it in place, a move gives it a new address) is
    quantized again. Not a parameter or buffer: the state_dict is
    unchanged."""
    w, b = conv.weight, conv.bias
    key = (w.data_ptr(), w._version,
           None if b is None else (b.data_ptr(), b._version))
    cached = conv.__dict__.get("_int8_prepared")
    if cached is None or cached[0] != key:
        with torch.no_grad():
            prepared = prepare_kernel(w.detach().permute(2, 3, 1, 0),
                                      None if b is None else b.detach())
        cached = (key, prepared)
        conv.__dict__["_int8_prepared"] = cached
    return cached[1]


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """``conv`` (stride 1, 'same' padding) applied to the channels_last NCHW
    activation ``x`` as an int8 conv (weights from ``prepared_kernel``), the
    result in ``dtype`` and channels_last. An ``x`` that overrides torch
    functions (``parallel/spatial.py``'s slabs) takes the call."""
    if has_torch_function_unary(x):
        return handle_torch_function(conv2d, (x,), conv, x, dtype)
    y = int8_conv(x.permute(0, 2, 3, 1), prepared=prepared_kernel(conv),
                  out_dtype=dtype)
    return y.permute(0, 3, 1, 2)
