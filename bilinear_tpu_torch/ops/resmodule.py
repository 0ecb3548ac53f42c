"""The torch7 bottleneck ResModule, fused (kernels K3 and K4; counterpart of
``bilinear_tpu/ops/pallas/resmodule.py``).

The block, on (N = B*H*W, C) rows of an NHWC activation:

    skip = x @ skip_w + skip_b   (or x when Ci == Co)
    a1 = relu(bn1(x));  h1 = a1 @ w1 + b1                  # Ci -> Ch
    a2 = relu(bn2(h1)); h2 = sum_t mask_t * a2[q + d_t] @ w2[t] + b2   # 3x3
    a3 = relu(bn3(h2)); out = skip + a3 @ w3 + b3          # Ch -> Co

``res_block_train`` is a ``torch.autograd.Function``: its forward is K3 in
train mode (it also returns each BN's batch mean and biased variance) and
its backward is K4. ``res_block_eval`` is K3 with running statistics. On a
CUDA tensor they launch ``csrc/resmodule.cu``; on a CPU tensor they run
``res_block_ref`` / ``res_block_bwd_ref``, the plain PyTorch versions of the
same arithmetic. There is no fallback from one to the other.

Numerical contract (the TPU kernel's, ``resmodule.py:34-40`` there): BN
arithmetic in f32 on values already rounded to ``dtype``; products of
``dtype`` values accumulate in f32; each conv output is rounded to
``dtype`` and then its bias, rounded to ``dtype``, is added in ``dtype``;
the skip product and the block's last conv are rounded separately and
summed in ``dtype``. In the backward, g_h2, g_y2 and g_h1 are rounded to
``dtype``; every parameter gradient is f32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from bilinear_tpu_torch.ops import _build

EPS = 1e-5
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# ResModule calls that went through the CUDA kernels: one per call of the
# C entry (a forward launches 3 to 16 kernels, a backward 32 to 35).
LAUNCHES_FWD_TRAIN = 0
LAUNCHES_FWD_EVAL = 0
LAUNCHES_BWD = 0

# Tiling constants shared with csrc/resmodule.cu.
_CHANNEL_MULTIPLE = 64   # every channel count (GEMM column tile)
_MAX_CHANNELS = 256      # BN parameters staged in shared memory
_ROWS_PER_COL_BLOCK = 256  # rows per block of the column reductions


class ResParams(NamedTuple):
    """1x1 kernels as (in, out) matrices, the 3x3 kernel as (9, in, out) in
    ``TAPS`` order, biases and BN gamma/beta as (C,) vectors. ``skip_w`` and
    ``skip_b`` are None for the identity skip (Ci == Co)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    g1: torch.Tensor
    be1: torch.Tensor
    g2: torch.Tensor
    be2: torch.Tensor
    g3: torch.Tensor
    be3: torch.Tensor
    skip_w: Optional[torch.Tensor] = None
    skip_b: Optional[torch.Tensor] = None


class BatchStats(NamedTuple):
    m1: torch.Tensor
    v1: torch.Tensor
    m2: torch.Tensor
    v2: torch.Tensor
    m3: torch.Tensor
    v3: torch.Tensor


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' check on the card).
# Every tensor is held in f32; ``_rd`` rounds to the working type and back.
# ---------------------------------------------------------------------------


def _rd(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).float()


def _tap_masks(n: int, h: int, w: int, device, sign: int = 1):
    """(N, 1) validity of each tap (sign * dy, sign * dx) for output rows."""
    q = torch.arange(n, device=device)
    xq = (q % w)[:, None]
    yq = ((q // w) % h)[:, None]
    masks = []
    for dy, dx in TAPS:
        dy, dx = sign * dy, sign * dx
        masks.append((xq + dx >= 0) & (xq + dx < w) & (yq + dy >= 0)
                      & (yq + dy < h))
    return masks


def _stats(h: torch.Tensor):
    m = h.mean(dim=0)
    return m, (h - m).square().mean(dim=0)


def _bn(h, g, be, m, v):
    """(hhat, y) of train/eval BN given statistics, f32."""
    hhat = (h - m) * torch.rsqrt(v + EPS)
    return hhat, hhat * g + be


def _conv3x3(a2, w2, masks, w: int):
    """Sum over taps of the masked, shifted rows times w2[t], f32."""
    acc = torch.zeros((a2.shape[0], w2.shape[-1]), device=a2.device)
    for t, (dy, dx) in enumerate(TAPS):
        shifted = torch.roll(a2, -(dy * w + dx), dims=0)
        acc = acc + torch.where(masks[t], shifted, 0.0) @ w2[t]
    return acc


def _prep(p: ResParams, dtype):
    """Weights rounded to the working type, the rest f32."""
    f = {k: (None if v is None else v.float()) for k, v in p._asdict().items()}
    for k in ("w1", "w2", "w3", "skip_w"):
        if f[k] is not None:
            f[k] = _rd(f[k], dtype)
    return ResParams(**f)


def _bias(b, dtype):
    return _rd(b.float(), dtype)


def res_block_ref(x4d: torch.Tensor, p: ResParams, *, train: bool,
                  stats: Optional[BatchStats] = None,
                  dtype=torch.bfloat16) -> Tuple[torch.Tensor, BatchStats]:
    """(B, H, W, Ci) -> ((B, H, W, Co) in ``dtype``, batch stats f32). In
    train mode the stats come from the batch; in eval mode pass the running
    statistics."""
    b, h, w, ci = x4d.shape
    n = b * h * w
    p = _prep(p, dtype)
    x = _rd(x4d.reshape(n, ci), dtype)
    masks = _tap_masks(n, h, w, x.device)

    m1, v1 = _stats(x) if train else (stats.m1.float(), stats.v1.float())
    a1 = _rd(torch.relu(_bn(x, p.g1, p.be1, m1, v1)[1]), dtype)
    h1 = _rd(_rd(a1 @ p.w1, dtype) + _bias(p.b1, dtype), dtype)

    m2, v2 = _stats(h1) if train else (stats.m2.float(), stats.v2.float())
    a2 = _rd(torch.relu(_bn(h1, p.g2, p.be2, m2, v2)[1]), dtype)
    h2 = _rd(_rd(_conv3x3(a2, p.w2, masks, w), dtype) + _bias(p.b2, dtype),
             dtype)

    m3, v3 = _stats(h2) if train else (stats.m3.float(), stats.v3.float())
    a3 = _rd(torch.relu(_bn(h2, p.g3, p.be3, m3, v3)[1]), dtype)
    h3 = _rd(_rd(a3 @ p.w3, dtype) + _bias(p.b3, dtype), dtype)

    if p.skip_w is not None:
        skip = _rd(_rd(x @ p.skip_w, dtype) + _bias(p.skip_b, dtype), dtype)
    else:
        skip = x
    out = (skip + h3).to(dtype).reshape(b, h, w, -1)
    return out, BatchStats(m1, v1, m2, v2, m3, v3)


def res_block_bwd_ref(x4d: torch.Tensor, g_out4d: torch.Tensor,
                      p: ResParams, stats: BatchStats, *,
                      dtype=torch.bfloat16) -> Tuple[torch.Tensor, ResParams]:
    """K4's arithmetic, formula by formula (``_bwd_kernel_body_chunked``):
    returns (g_x (B, H, W, Ci) in ``dtype``, gradients as ResParams, f32).
    Not autograd, so that it rounds g_h2, g_y2 and g_h1 where K4 does."""
    b, h, w, ci = x4d.shape
    n = b * h * w
    nf = float(n)
    p = _prep(p, dtype)
    m1, v1, m2, v2, m3, v3 = (s.float() for s in stats)
    rs1, rs2, rs3 = (torch.rsqrt(v + EPS) for v in (v1, v2, v3))
    x = _rd(x4d.reshape(n, ci), dtype)
    g = _rd(g_out4d.reshape(n, -1), dtype)
    fwd_masks = _tap_masks(n, h, w, x.device)
    bwd_masks = _tap_masks(n, h, w, x.device, sign=-1)

    # recompute h1, a2, h2
    hhat1, y1 = _bn(x, p.g1, p.be1, m1, v1)
    a1 = _rd(torch.relu(y1), dtype)
    h1 = _rd(_rd(a1 @ p.w1, dtype) + _bias(p.b1, dtype), dtype)
    hhat2, y2 = _bn(h1, p.g2, p.be2, m2, v2)
    a2 = _rd(torch.relu(y2), dtype)
    h2 = _rd(_rd(_conv3x3(a2, p.w2, fwd_masks, w), dtype)
             + _bias(p.b2, dtype), dtype)

    # conv3 / skip weight grads, bn3 reductions
    db3 = g.sum(0)
    hhat3, y3 = _bn(h2, p.g3, p.be3, m3, v3)
    a3 = _rd(torch.relu(y3), dtype)
    dw3 = a3.t() @ g
    gy3 = torch.where(y3 > 0.0, g @ p.w3.t(), 0.0)
    dg3, dbe3 = (gy3 * hhat3).sum(0), gy3.sum(0)
    dskip_w = x.t() @ g if p.skip_w is not None else None

    # g_h2
    gh2 = _rd((rs3 / nf) * (nf * (gy3 * p.g3) - p.g3 * dbe3
                            - hhat3 * (p.g3 * dg3)), dtype)

    # conv2 weight grads
    db2 = gh2.sum(0)
    dw2 = torch.stack([
        (torch.where(fwd_masks[t], torch.roll(a2, -(dy * w + dx), dims=0),
                     0.0)).t() @ gh2
        for t, (dy, dx) in enumerate(TAPS)
    ])

    # g_a2 -> g_y2, bn2 reductions
    ga2 = torch.zeros_like(h1)
    for t, (dy, dx) in enumerate(TAPS):
        contrib = torch.roll(gh2, dy * w + dx, dims=0) @ p.w2[t].t()
        ga2 = ga2 + torch.where(bwd_masks[t], contrib, 0.0)
    gy2 = torch.where(y2 > 0.0, ga2, 0.0)
    dg2, dbe2 = (gy2 * hhat2).sum(0), gy2.sum(0)

    # g_h1 (from g_y2 as stored in the working type)
    gh1 = _rd((rs2 / nf) * (nf * (_rd(gy2, dtype) * p.g2) - p.g2 * dbe2
                            - hhat2 * (p.g2 * dg2)), dtype)

    # conv1 grads, bn1 reductions
    db1 = gh1.sum(0)
    dw1 = a1.t() @ gh1
    gy1 = torch.where(y1 > 0.0, gh1 @ p.w1.t(), 0.0)
    dg1, dbe1 = (gy1 * hhat1).sum(0), gy1.sum(0)

    # g_x
    gx = (rs1 / nf) * (nf * (gy1 * p.g1) - p.g1 * dbe1
                       - hhat1 * (p.g1 * dg1))
    gx = gx + (g @ p.skip_w.t() if p.skip_w is not None else g)
    grads = ResParams(
        w1=dw1, b1=db1, w2=dw2, b2=db2, w3=dw3, b3=db3,
        g1=dg1, be1=dbe1, g2=dg2, be2=dbe2, g3=dg3, be3=dbe3,
        skip_w=dskip_w, skip_b=db3.clone() if dskip_w is not None else None,
    )
    return gx.to(dtype).reshape(b, h, w, ci), grads


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_FWD_ARGTYPES = [_I] * 8 + [_P] * 26
_BWD_ARGTYPES = [_I] * 7 + [_P] * 46 + [_I, _I, _P]


def _lib():
    lib = _build.library("resmodule")
    lib.resmodule_forward.argtypes = _FWD_ARGTYPES
    lib.resmodule_forward.restype = _I
    lib.resmodule_backward.argtypes = _BWD_ARGTYPES
    lib.resmodule_backward.restype = _I
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_cuda(x4d: torch.Tensor, p: ResParams, dtype) -> Tuple[int, ...]:
    """Shape (b, h, w, ci, ch, co) the kernels take; raises otherwise."""
    if x4d.device.type != "cuda":
        raise ValueError("the resmodule kernels need a CUDA tensor")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {dtype}")
    if x4d.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x4d.shape)}")
    b, h, w, ci = x4d.shape
    ch, co = p.w1.shape[1], p.w3.shape[1]
    for c in (ci, ch, co):
        if c % _CHANNEL_MULTIPLE or c > _MAX_CHANNELS:
            raise ValueError(
                f"channels ({ci}, {ch}, {co}): the kernels take multiples "
                f"of {_CHANNEL_MULTIPLE} up to {_MAX_CHANNELS}")
    if (p.skip_w is None) != (ci == co):
        raise ValueError("skip_w is given exactly when Ci != Co")
    if b * h * w >= 2 ** 31 // _MAX_CHANNELS:
        raise ValueError("too many rows for 32-bit indexing")
    return b, h, w, ci, ch, co


def _cuda_params(p: ResParams, dtype, device):
    """Kernel operands: weights contiguous in the working type, the rest
    contiguous f32."""
    def wt(t):
        return None if t is None else t.to(device=device, dtype=dtype) \
            .contiguous()

    def f32(t):
        return None if t is None else t.to(device=device,
                                           dtype=torch.float32).contiguous()

    return ResParams(
        w1=wt(p.w1), b1=f32(p.b1), w2=wt(p.w2), b2=f32(p.b2), w3=wt(p.w3),
        b3=f32(p.b3), g1=f32(p.g1), be1=f32(p.be1), g2=f32(p.g2),
        be2=f32(p.be2), g3=f32(p.g3), be3=f32(p.be3), skip_w=wt(p.skip_w),
        skip_b=f32(p.skip_b))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (the kernels load 16 bytes
    at a time); a view at an unaligned offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _col_partials(n: int, c: int) -> int:
    return 2 * -(-n // _ROWS_PER_COL_BLOCK) * c


def _fwd_cuda(x4d, p: ResParams, train: bool, stats: Optional[BatchStats],
              dtype):
    global LAUNCHES_FWD_TRAIN, LAUNCHES_FWD_EVAL
    b, h, w, ci, ch, co = _check_cuda(x4d, p, dtype)
    dev = x4d.device
    n = b * h * w
    x = _aligned(x4d.to(dtype))
    q = _cuda_params(p, dtype, dev)
    if train:
        st = BatchStats(*(torch.empty(c, device=dev) for c in
                          (ci, ci, ch, ch, ch, ch)))
    else:
        st = BatchStats(*(s.to(device=dev, dtype=torch.float32).contiguous()
                          for s in stats))
    out = torch.empty((b, h, w, co), device=dev, dtype=dtype)
    h12 = torch.empty((2, n, ch), device=dev, dtype=dtype)
    part = torch.empty(_col_partials(n, max(ci, ch)), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().resmodule_forward(
            int(dtype == torch.bfloat16), int(train), b, h, w, ci, ch, co,
            x.data_ptr(), q.w1.data_ptr(), q.b1.data_ptr(), q.w2.data_ptr(),
            q.b2.data_ptr(), q.w3.data_ptr(), q.b3.data_ptr(),
            q.g1.data_ptr(), q.be1.data_ptr(), q.g2.data_ptr(),
            q.be2.data_ptr(), q.g3.data_ptr(), q.be3.data_ptr(),
            _ptr(q.skip_w), _ptr(q.skip_b), *(s.data_ptr() for s in st),
            out.data_ptr(), h12[0].data_ptr(), h12[1].data_ptr(),
            part.data_ptr(), stream)
    _build.check(rc, "resmodule_forward")
    if train:
        LAUNCHES_FWD_TRAIN += 1
    else:
        LAUNCHES_FWD_EVAL += 1
    return out, st


def _wgrad_split(n: int) -> Tuple[int, int]:
    """(splits, rows per split) of the weight-gradient reductions over N."""
    splits = min(64, max(1, -(-n // 2048)))
    rows = -(-n // splits)
    rows = -(-rows // 32) * 32
    return -(-n // rows), rows


def _bwd_cuda(x4d, g_out4d, p: ResParams, stats: BatchStats, dtype):
    global LAUNCHES_BWD
    b, h, w, ci, ch, co = _check_cuda(x4d, p, dtype)
    dev = x4d.device
    n = b * h * w
    x = _aligned(x4d.to(dtype))
    g = _aligned(g_out4d.to(dtype))
    if g.shape != (b, h, w, co):
        raise ValueError(f"g_out {tuple(g.shape)} for output "
                         f"{(b, h, w, co)}")
    q = _cuda_params(p, dtype, dev)
    st = BatchStats(*(s.to(device=dev, dtype=torch.float32).contiguous()
                      for s in stats))
    # Transposed weights for the data gradients: (out, in) row-major, and
    # w2 as the (9 * Ch, Ch) stack of w2[t]^T.
    w1t = q.w1.t().contiguous()
    w2t = q.w2.transpose(1, 2).contiguous()
    w3t = q.w3.t().contiguous()
    wskt = None if q.skip_w is None else q.skip_w.t().contiguous()

    f32 = dict(device=dev, dtype=torch.float32)
    gx = torch.empty((b, h, w, ci), device=dev, dtype=dtype)
    grads = ResParams(
        w1=torch.empty((ci, ch), **f32), b1=torch.empty(ch, **f32),
        w2=torch.empty((9, ch, ch), **f32), b2=torch.empty(ch, **f32),
        w3=torch.empty((ch, co), **f32), b3=torch.empty(co, **f32),
        g1=torch.empty(ci, **f32), be1=torch.empty(ci, **f32),
        g2=torch.empty(ch, **f32), be2=torch.empty(ch, **f32),
        g3=torch.empty(ch, **f32), be3=torch.empty(ch, **f32),
        skip_w=None if wskt is None else torch.empty((ci, co), **f32),
        skip_b=None if wskt is None else torch.empty(co, **f32),
    )
    tmp = torch.empty((4, n, ch), device=dev, dtype=dtype)  # h1 h2 gh2 gh1
    gyc = torch.empty((n, ch), **f32)
    gy1 = torch.empty((n, ci), **f32)
    skd = None if wskt is None else torch.empty((n, ci), **f32)
    splits, rows = _wgrad_split(n)
    wpart = torch.empty(splits * max(ci * ch, 9 * ch * ch, ch * co, ci * co),
                        **f32)
    cpart = torch.empty(_col_partials(n, max(ci, ch, co)), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().resmodule_backward(
            int(dtype == torch.bfloat16), b, h, w, ci, ch, co,
            x.data_ptr(), g.data_ptr(),
            q.w1.data_ptr(), q.b1.data_ptr(), q.w2.data_ptr(),
            q.b2.data_ptr(), q.g1.data_ptr(), q.be1.data_ptr(),
            q.g2.data_ptr(), q.be2.data_ptr(), q.g3.data_ptr(),
            q.be3.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
            w3t.data_ptr(), _ptr(wskt), *(s.data_ptr() for s in st),
            gx.data_ptr(), *(_ptr(t) for t in grads),
            tmp[0].data_ptr(), tmp[1].data_ptr(), tmp[2].data_ptr(),
            tmp[3].data_ptr(), gyc.data_ptr(), gy1.data_ptr(), _ptr(skd),
            wpart.data_ptr(), cpart.data_ptr(),
            splits, rows, stream)
    _build.check(rc, "resmodule_backward")
    LAUNCHES_BWD += 1
    return gx, grads


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

_PARAM_FIELDS = ResParams._fields


class _ResBlockTrain(torch.autograd.Function):
    """K3 (train mode) forward, K4 backward. Saves only x, the parameters
    and the six stat rows, as the TPU kernel's custom_vjp does; the stats
    outputs carry no gradient."""

    @staticmethod
    def forward(ctx, x4d, dtype, *params):
        p = ResParams(*params)
        if x4d.device.type == "cpu":
            out, st = res_block_ref(x4d, p, train=True, dtype=dtype)
        else:
            out, st = _fwd_cuda(x4d, p, True, None, dtype)
        ctx.dtype = dtype
        ctx.has_skip = p.skip_w is not None
        ctx.save_for_backward(x4d, *(t for t in params if t is not None),
                              *st)
        ctx.mark_non_differentiable(*st)
        return (out, *st)

    @staticmethod
    def backward(ctx, g_out, *_g_stats):
        saved = ctx.saved_tensors
        x4d = saved[0]
        n_p = len(_PARAM_FIELDS) - (0 if ctx.has_skip else 2)
        vals = list(saved[1:1 + n_p]) + [None] * (len(_PARAM_FIELDS) - n_p)
        p = ResParams(*vals)
        st = BatchStats(*saved[1 + n_p:])
        g_out = g_out.contiguous()
        if x4d.device.type == "cpu":
            gx, grads = res_block_bwd_ref(x4d, g_out, p, st, dtype=ctx.dtype)
        else:
            gx, grads = _bwd_cuda(x4d, g_out, p, st, ctx.dtype)
        return (gx, None, *grads)


def res_block_train(x4d: torch.Tensor, p: ResParams, *,
                    dtype=torch.bfloat16) -> Tuple[torch.Tensor, BatchStats]:
    """Fused train-mode forward, differentiable: (B, H, W, Ci) ->
    ((B, H, W, Co), BatchStats). ``x4d`` is cast to ``dtype`` before the
    autograd boundary, so its gradient has the working type."""
    res = _ResBlockTrain.apply(x4d.to(dtype), dtype, *p)
    return res[0], BatchStats(*res[1:])


def res_block_eval(x4d: torch.Tensor, p: ResParams, stats: BatchStats, *,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Fused eval-mode forward with running statistics. Not differentiable
    (neither is the TPU kernel's eval call)."""
    if x4d.device.type == "cpu":
        return res_block_ref(x4d, p, train=False, stats=stats, dtype=dtype)[0]
    if torch.is_grad_enabled() and (x4d.requires_grad or any(
            t is not None and t.requires_grad for t in p)):
        raise RuntimeError("res_block_eval has no backward; run it under "
                           "torch.no_grad() or use res_block_train")
    return _fwd_cuda(x4d, p, False, stats, dtype)[0]
