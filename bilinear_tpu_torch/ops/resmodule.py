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
``dtype``; every parameter gradient is f32. The plain versions also take
``dtype=torch.float64`` (everything in float64; the kernels do not).

Data parallelism. JAX's fused block inside a GSPMD program sees the global
batch, so its BN statistics are the global batch's. Here a rank holds its
rows only, and ``exchange=`` (a ``RankExchange`` over the data group) makes
each of the three BN reductions global: the forward's (count, mean, M2) per
channel and the backward's (sum gy * hhat, sum gy) are gathered from every
rank and merged in rank order (Chan's formula for the statistics, a sum for
the backward's reductions), the same bits on every rank. A C entry cannot
call ``torch.distributed``, so on the card a staged call runs the entry
four times (``STAGES``), gathering between the stages. The running
statistics are updated once, with the global count; dgamma and dbeta stay
this rank's share (the trainer sums every parameter gradient over the
group), and only the data gradient uses the global sums. Without an
exchange (one rank, or no mesh) the call is the one-entry call.

Spans (``utils/profiling.py::span``, recorded only while a profiler
records), ``SPANS``: ``k3.forward`` is one forward call, train or eval
(argument checks, the slot array and the C entry with its launches on the
card; the plain version on the CPU), ``k4.backward`` one backward.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.overrides import handle_torch_function, has_torch_function_unary

from bilinear_tpu_torch.ops import _build
from bilinear_tpu_torch.utils import debug
from bilinear_tpu_torch.utils.profiling import span

EPS = 1e-5
SPANS = ("k3.forward", "k4.backward")
TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# ResModule calls that went through the CUDA kernels: one per call of the
# C entry (a train forward launches 8 kernels, an eval forward 4, a backward
# 16, or 18 with a 1x1 skip; the wrapper launches none of its own).
LAUNCHES_FWD_TRAIN = 0
LAUNCHES_FWD_EVAL = 0
LAUNCHES_BWD = 0
# Stage entries of staged calls (a train forward or a backward under a data
# group): four per call, each also counted once above.
LAUNCHES_FWD_STAGES = 0
LAUNCHES_BWD_STAGES = 0
STAGES = 4

# Tiling constants shared with csrc/resmodule.cu.
_CHANNEL_MULTIPLE = 64   # every channel count (GEMM column tile)
_MAX_CHANNELS = 256      # BN parameters staged in shared memory
STAT_TILE_ROWS = 128     # rows of a GEMM tile and of a statistics partial
STAT_GROUPS = 32         # ordered groups of the statistics' merge


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


class RankExchange(NamedTuple):
    """The data group a fused block's BN reductions span: ``gather`` maps
    this rank's row (a 1-d tensor) to every rank's row, stacked in rank
    order, the same on every rank; ``rows`` is the global batch's row
    count (B, not B*H*W)."""

    gather: Callable[[torch.Tensor], torch.Tensor]
    rows: int


def group_exchange(group, rows: int) -> RankExchange:
    """A ``RankExchange`` over a ``torch.distributed`` group: each rank
    writes its row into its slot of a zeroed (world, len) buffer and the
    buffer is all-reduced (a sum with zeros is exact in any order, and
    every backend takes an all-reduce of a CUDA tensor)."""
    def gather(row: torch.Tensor) -> torch.Tensor:
        buf = row.new_zeros((dist.get_world_size(group), row.numel()))
        buf[dist.get_rank(group)] = row
        dist.all_reduce(buf, group=group)
        return buf

    return RankExchange(gather, int(rows))


class RunningStats(NamedTuple):
    """The three BNs' running means, running variances and
    ``num_batches_tracked`` counters (f32, f32, int64), updated in place by
    ``res_block_train``, and their common momentum."""

    mean: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    var: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    count: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    momentum: float


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' check on the card).
# Every tensor is held in f32; ``_rd`` rounds to the working type and back.
# ---------------------------------------------------------------------------


def _wide(dtype):
    """The type the plain versions compute in: f32, or float64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rd(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).to(_wide(dtype))


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


def merged_tile_stats(h: torch.Tensor, tile: int = STAT_TILE_ROWS,
                      groups: int = STAT_GROUPS):
    """``_stats`` the way the kernels take it in one pass: (mean, M2) of
    every tile of ``tile`` rows (the last may be ragged), merged with Chan's
    formula in a fixed order (``groups`` runs of consecutive tiles, each
    merged in order, then the runs in order). Returns (mean, biased
    variance), f32."""
    n = h.shape[0]
    tiles = [h[i:i + tile] for i in range(0, n, tile)]
    parts = []
    for t in tiles:
        m = t.sum(0) / t.shape[0]
        parts.append((float(t.shape[0]), m, (t - m).square().sum(0)))

    def merge(a, b):
        (na, ma, m2a), (nb, mb, m2b) = a, b
        tot = na + nb
        d = mb - ma
        f = torch.tensor(nb, dtype=torch.float32) / tot
        return tot, ma + d * f, (m2a + m2b) + (d * d) * (na * f)

    def fold(items):
        acc = items[0]
        for it in items[1:]:
            acc = merge(acc, it)
        return acc

    per = -(-len(parts) // groups)
    runs = [fold(parts[i:i + per]) for i in range(0, len(parts), per)]
    _, mean, m2 = fold(runs)
    return mean, m2 / n


@torch.no_grad()
def update_running_ref(running: RunningStats, st: BatchStats, n: int) -> None:
    """The in-place running-statistics update of ``res_block_train``, plain
    version: torch's BatchNorm rule with a numeric momentum."""
    f = running.momentum
    unbias = n / max(n - 1, 1)
    batch = ((st.m1, st.v1), (st.m2, st.v2), (st.m3, st.v3))
    for mean, var, count, (m, v) in zip(running.mean, running.var,
                                        running.count, batch):
        count += 1
        mean.copy_((1 - f) * mean + f * m)
        var.copy_((1 - f) * var + f * (v * unbias))


def _bn(h, g, be, m, v):
    """(hhat, y) of train/eval BN given statistics, f32."""
    hhat = (h - m) * torch.rsqrt(v + EPS)
    return hhat, hhat * g + be


def _conv3x3(a2, w2, masks, w: int):
    """Sum over taps of the masked, shifted rows times w2[t], f32."""
    acc = torch.zeros((a2.shape[0], w2.shape[-1]), device=a2.device,
                      dtype=a2.dtype)
    for t, (dy, dx) in enumerate(TAPS):
        shifted = torch.roll(a2, -(dy * w + dx), dims=0)
        acc = acc + torch.where(masks[t], shifted, 0.0) @ w2[t]
    return acc


def _prep(p: ResParams, dtype):
    """Weights rounded to the working type, the rest f32 (float64)."""
    wide = _wide(dtype)
    f = {k: (None if v is None else v.to(wide))
         for k, v in p._asdict().items()}
    for k in ("w1", "w2", "w3", "skip_w"):
        if f[k] is not None:
            f[k] = _rd(f[k], dtype)
    return ResParams(**f)


def _bias(b, dtype):
    return _rd(b.to(_wide(dtype)), dtype)


def merge_rank_stats(rows: torch.Tensor, c: int):
    """The ranks' (mean (c,), M2 (c,), count) rows, stacked in rank order,
    merged by Chan's formula in that order from the first rank that holds
    rows (``rank_merge_k``'s arithmetic; a rank of no rows is skipped):
    (mean, biased variance, count)."""
    n = mean = m2 = None
    for r in range(rows.shape[0]):
        nb, mb, m2b = rows[r, 2 * c], rows[r, :c], rows[r, c:2 * c]
        if float(nb) == 0.0:
            continue
        if n is None:
            n, mean, m2 = nb, mb, m2b
            continue
        tot = n + nb
        d = mb - mean
        f = nb / tot
        mean = mean + d * f
        m2 = (m2 + m2b) + (d * d) * (n * f)
        n = tot
    return mean, m2 / n, n


def sum_rank_rows(rows: torch.Tensor, c: int):
    """The ranks' (a (c,), b (c,)) rows summed in rank order from rank 0's
    (``rank_sum_k``'s order)."""
    a, b = rows[0, :c], rows[0, c:2 * c]
    for r in range(1, rows.shape[0]):
        a = a + rows[r, :c]
        b = b + rows[r, c:2 * c]
    return a, b


def _global_stats(h: torch.Tensor, exchange: RankExchange):
    """The global batch's (mean, biased variance) of ``h``'s columns: this
    rank's (mean, M2, count) exchanged and merged in rank order (a rank of
    no rows sends zeros)."""
    m = h.mean(dim=0) if h.shape[0] else h.new_zeros(h.shape[1])
    m2 = (h - m).square().sum(dim=0)
    row = torch.cat([m, m2, h.new_tensor([float(h.shape[0])])])
    mean, var, _ = merge_rank_stats(exchange.gather(row), h.shape[1])
    return mean, var


def _global_sums(a: torch.Tensor, b: torch.Tensor,
                 exchange: Optional[RankExchange]):
    """The data group's sums of this rank's reductions ``a``, ``b``
    (themselves without an exchange)."""
    if exchange is None:
        return a, b
    return sum_rank_rows(exchange.gather(torch.cat([a, b])), a.shape[0])


def res_block_ref(x4d: torch.Tensor, p: ResParams, *, train: bool,
                  stats: Optional[BatchStats] = None,
                  dtype=torch.bfloat16,
                  exchange: Optional[RankExchange] = None
                  ) -> Tuple[torch.Tensor, BatchStats]:
    """(B, H, W, Ci) -> ((B, H, W, Co) in ``dtype``, batch stats f32). In
    train mode the stats come from the batch (the global batch's over
    ``exchange``); in eval mode pass the running statistics."""
    b, h, w, ci = x4d.shape
    n = b * h * w
    wide = _wide(dtype)
    p = _prep(p, dtype)
    x = _rd(x4d.reshape(n, ci), dtype)
    masks = _tap_masks(n, h, w, x.device)

    def batch(t, m, v):
        if not train:
            return m.to(wide), v.to(wide)
        return _stats(t) if exchange is None else _global_stats(t, exchange)

    m1, v1 = batch(x, *(stats[:2] if stats else (None, None)))
    a1 = _rd(torch.relu(_bn(x, p.g1, p.be1, m1, v1)[1]), dtype)
    h1 = _rd(_rd(a1 @ p.w1, dtype) + _bias(p.b1, dtype), dtype)

    m2, v2 = batch(h1, *(stats[2:4] if stats else (None, None)))
    a2 = _rd(torch.relu(_bn(h1, p.g2, p.be2, m2, v2)[1]), dtype)
    h2 = _rd(_rd(_conv3x3(a2, p.w2, masks, w), dtype) + _bias(p.b2, dtype),
             dtype)

    m3, v3 = batch(h2, *(stats[4:] if stats else (None, None)))
    a3 = _rd(torch.relu(_bn(h2, p.g3, p.be3, m3, v3)[1]), dtype)
    h3 = _rd(_rd(a3 @ p.w3, dtype) + _bias(p.b3, dtype), dtype)

    if p.skip_w is not None:
        skip = _rd(_rd(x @ p.skip_w, dtype) + _bias(p.skip_b, dtype), dtype)
    else:
        skip = x
    out = (skip + h3).to(dtype).reshape(b, h, w, h3.shape[1])
    return out, BatchStats(m1, v1, m2, v2, m3, v3)


def res_block_bwd_ref(x4d: torch.Tensor, g_out4d: torch.Tensor,
                      p: ResParams, stats: BatchStats, *,
                      dtype=torch.bfloat16,
                      exchange: Optional[RankExchange] = None
                      ) -> Tuple[torch.Tensor, ResParams]:
    """K4's arithmetic, formula by formula (``_bwd_kernel_body_chunked``):
    returns (g_x (B, H, W, Ci) in ``dtype``, gradients as ResParams, f32).
    Not autograd, so that it rounds g_h2, g_y2 and g_h1 where K4 does.
    Over ``exchange`` each BN's data gradient takes the group's sums and
    the global count; the returned gradients are this rank's share."""
    b, h, w, ci = x4d.shape
    n = b * h * w
    nf = float(n if exchange is None else exchange.rows * h * w)
    p = _prep(p, dtype)
    m1, v1, m2, v2, m3, v3 = (s.to(_wide(dtype)) for s in stats)
    rs1, rs2, rs3 = (torch.rsqrt(v + EPS) for v in (v1, v2, v3))
    x = _rd(x4d.reshape(n, ci), dtype)
    g = _rd(g_out4d.reshape(n, g_out4d.shape[-1]), dtype)
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
    sg3, sb3 = _global_sums(dg3, dbe3, exchange)
    gh2 = _rd((rs3 / nf) * (nf * (gy3 * p.g3) - p.g3 * sb3
                            - hhat3 * (p.g3 * sg3)), dtype)

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
    sg2, sb2 = _global_sums(dg2, dbe2, exchange)
    gh1 = _rd((rs2 / nf) * (nf * (_rd(gy2, dtype) * p.g2) - p.g2 * sb2
                            - hhat2 * (p.g2 * sg2)), dtype)

    # conv1 grads, bn1 reductions
    db1 = gh1.sum(0)
    dw1 = a1.t() @ gh1
    gy1 = torch.where(y1 > 0.0, gh1 @ p.w1.t(), 0.0)
    dg1, dbe1 = (gy1 * hhat1).sum(0), gy1.sum(0)

    # g_x
    sg1, sb1 = _global_sums(dg1, dbe1, exchange)
    gx = (rs1 / nf) * (nf * (gy1 * p.g1) - p.g1 * sb1
                       - hhat1 * (p.g1 * sg1))
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

_LL = ctypes.c_longlong
_I = ctypes.c_int
_lib_ready = None
_scratch_sizes = {}


def _lib():
    global _lib_ready
    if _lib_ready is None:
        lib = _build.library("resmodule")
        lib.resmodule_forward.argtypes = [ctypes.POINTER(_LL),
                                          ctypes.POINTER(ctypes.c_double)]
        lib.resmodule_forward.restype = _I
        lib.resmodule_backward.argtypes = [ctypes.POINTER(_LL)]
        lib.resmodule_backward.restype = _I
        lib.resmodule_scratch_bytes.argtypes = [_I] * 8
        lib.resmodule_scratch_bytes.restype = _LL
        for fn in (lib.resmodule_forward_slots, lib.resmodule_backward_slots):
            fn.argtypes = []
            fn.restype = ctypes.c_char_p
        lib.fwd_slots = lib.resmodule_forward_slots().decode().lower().split()
        lib.bwd_slots = lib.resmodule_backward_slots().decode().lower().split()
        _lib_ready = lib
    return _lib_ready


def _slot_array(names, vals: dict):
    """The C entry's argument array: ``vals`` laid out in the order of the
    slot names the library itself reports, so a value can only land in the
    slot of its name."""
    if len(vals) != len(names) or any(k not in vals for k in names):
        raise RuntimeError(
            f"argument slots differ from the library's: missing "
            f"{sorted(set(names) - vals.keys())}, unknown "
            f"{sorted(vals.keys() - set(names))}")
    return (_LL * len(names))(*[vals[k] for k in names])


def _scratch(lib, kind: int, bf: int, shape, dev) -> torch.Tensor:
    """One buffer for everything a call keeps between its launches (kind 0
    eval forward, 1 train forward, 2 backward); the C side carves it."""
    key = (kind, bf) + shape
    nbytes = _scratch_sizes.get(key)
    if nbytes is None:
        nbytes = _scratch_sizes[key] = int(
            lib.resmodule_scratch_bytes(kind, bf, *shape))
    if nbytes < 0:
        _, _, w, _, ch, _ = shape
        raise ValueError(
            f"image width {w} with {ch} bottleneck channels: the bf16 3x3 "
            f"kernel keeps 128 + 2 W + 2 rows of 2 Ch + 16 bytes in one "
            f"block's shared memory (W <= 217 at Ch = 128, 277 below 8192 "
            f"rows)")
    return torch.empty(nbytes, device=dev, dtype=torch.uint8)


def _vec(t: torch.Tensor, c: int, dev, what: str) -> int:
    """Address of a (c,) f32 vector on ``dev`` as the kernels read it."""
    ptr = t.data_ptr()
    if (t.dtype is not torch.float32 or t.device != dev or t.shape != (c,)
            or t.stride(0) != 1 or ptr % 16):
        raise ValueError(f"{what}: the kernels take a contiguous, 16-byte "
                         f"aligned float32 ({c},) vector on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return ptr


def _weight(slot: str, t: Optional[torch.Tensor], shape, dev) -> dict:
    """Slots {slot: address, slot_[st_]si: ..., slot_so: ...} of an f32
    weight, read where it lies by the kernel that packs the call's weights:
    any strides, so a transposed or permuted view of a conv weight costs no
    copy. None (no 1x1 skip) gives a null address."""
    keys = [slot] + [f"{slot}_{k}" for k in ("st", "si", "so")[-len(shape):]]
    if t is None:
        return dict.fromkeys(keys, 0)
    if t.dtype is not torch.float32 or t.device != dev or \
            tuple(t.shape) != shape:
        raise ValueError(f"{slot}: the kernels take a float32 {shape} weight "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return dict(zip(keys, (t.data_ptr(), *t.stride())))


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
    if b * h * w >= 2 ** 31 // _MAX_CHANNELS or h >= 2 ** 15 or w >= 2 ** 15:
        raise ValueError("too many rows for 32-bit indexing")
    return b, h, w, ci, ch, co


def _param_args(p: ResParams, shape, dev) -> dict:
    """The slots of the parameters both C entries read; the weights are
    read in place, by their strides, and rounded to the working type by the
    call's first launch."""
    _, _, _, ci, ch, co = shape
    args = {}
    args.update(_weight("w1", p.w1, (ci, ch), dev))
    args.update(_weight("w2", p.w2, (9, ch, ch), dev))
    args.update(_weight("w3", p.w3, (ch, co), dev))
    args.update(_weight("skw", p.skip_w, (ci, co), dev))
    for k, c in (("b1", ch), ("b2", ch), ("g1", ci), ("be1", ci), ("g2", ch),
                 ("be2", ch), ("g3", ch), ("be3", ch)):
        args[k] = _vec(getattr(p, k), c, dev, k)
    return args


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (the kernels load 16 bytes
    at a time); a view at an unaligned offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stat_args(stats: BatchStats, shape, dev) -> dict:
    _, _, _, ci, ch, _ = shape
    return {k: _vec(s, c, dev, k) for s, c, k in zip(
        stats, (ci, ci, ch, ch, ch, ch), BatchStats._fields)}


def _stage_slots(exchange: Optional[RankExchange], shape, dev):
    """The staged slots of a call without an exchange (one entry), else
    (slots, this rank's row buffer)."""
    if exchange is None:
        return dict(stage=-1, xch=0, gath=0, world=1, xstride=0), None
    _, _, _, ci, ch, _ = shape
    row = torch.zeros(2 * max(ci, ch) + 1, device=dev)
    return dict(stage=0, xch=row.data_ptr(), gath=0, world=1,
                xstride=row.numel()), row


def _run_staged(entry, names, vals: dict, row, exchange, *extra):
    """The four stages of a staged call, every rank's row gathered between
    them (on the call's stream, so a stage reads what the last one wrote);
    ``vals`` is updated in place. Returns the first non-zero code, else 0."""
    for k in range(STAGES):
        vals["stage"] = k
        rc = entry(_slot_array(names, vals), *extra)
        if rc or k + 1 == STAGES:
            return rc
        rows = exchange.gather(row).contiguous()
        if rows.dtype is not torch.float32 or rows.dim() != 2 or \
                rows.shape[1] != row.numel():
            raise ValueError(f"the exchange must return (world, "
                             f"{row.numel()}) f32 rows, got {rows.dtype} "
                             f"{tuple(rows.shape)}")
        vals.update(gath=rows.data_ptr(), world=rows.shape[0])


def _fwd_cuda(x4d, p: ResParams, train: bool, stats: Optional[BatchStats],
              dtype, running: Optional[RunningStats] = None,
              exchange: Optional[RankExchange] = None):
    global LAUNCHES_FWD_TRAIN, LAUNCHES_FWD_EVAL, LAUNCHES_FWD_STAGES
    shape = _check_cuda(x4d, p, dtype)
    b, h, w, ci, ch, co = shape
    dev = x4d.device
    n = b * h * w
    x = _aligned(x4d.to(dtype))
    lib = _lib()
    bf = int(dtype == torch.bfloat16)
    q = _param_args(p, shape, dev)
    if train:
        st = BatchStats(*torch.empty(2 * ci + 4 * ch, device=dev).split(
            (ci, ci, ch, ch, ch, ch)))
    else:
        st = stats
    run = dict.fromkeys(
        (f"run_{k}{i}" for k in ("mean", "var", "count") for i in (1, 2, 3)),
        0)
    floats = (ctypes.c_double * 2)(0.0, 1.0)
    if running is not None:
        if not train or running.momentum is None:
            raise ValueError("running statistics are updated in train mode "
                             "with a numeric momentum")
        for i, c in enumerate((ci, ch, ch)):
            run[f"run_mean{i + 1}"] = _vec(running.mean[i], c, dev,
                                           "running mean")
            run[f"run_var{i + 1}"] = _vec(running.var[i], c, dev,
                                          "running var")
            t = running.count[i]
            if t.dtype is not torch.int64 or t.device != dev or t.numel() != 1:
                raise ValueError("num_batches_tracked must be one int64 on "
                                 f"{dev}")
            run[f"run_count{i + 1}"] = t.data_ptr()
        n_all = n if exchange is None else exchange.rows * h * w
        floats = (ctypes.c_double * 2)(float(running.momentum),
                                       n_all / max(n_all - 1, 1))
    if exchange is not None and not train:
        raise ValueError("only a train forward spans a data group")
    if train and exchange is None and b == 0:
        raise ValueError("a train forward of no rows needs a data group")
    out = torch.empty((b, h, w, co), device=dev, dtype=dtype)
    scratch = _scratch(lib, int(train), bf, shape, dev)
    staged, row = _stage_slots(exchange, shape, dev)
    vals = dict(
        q, **_stat_args(st, shape, dev), **run, **staged,
        bf16=bf, train=int(train), b=b, h=h, w=w, ci=ci, ch=ch, co=co,
        x=x.data_ptr(), b3=_vec(p.b3, co, dev, "b3"),
        skb=0 if p.skip_b is None else _vec(p.skip_b, co, dev, "skip_b"),
        out=out.data_ptr(), scratch=scratch.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if exchange is None:
            rc = lib.resmodule_forward(_slot_array(lib.fwd_slots, vals),
                                       floats)
        else:
            rc = _run_staged(lib.resmodule_forward, lib.fwd_slots, vals,
                             row, exchange, floats)
            LAUNCHES_FWD_STAGES += STAGES
    _build.check(rc, "resmodule_forward")
    if train:
        LAUNCHES_FWD_TRAIN += 1
    else:
        LAUNCHES_FWD_EVAL += 1
    return out, st


def _param_strides(t: torch.Tensor) -> Tuple[int, ...]:
    """``t``'s own strides when it fills its memory without gaps or overlap
    (a transposed or permuted view of a contiguous parameter), else the
    contiguous ones: the layout a gradient of ``t`` is written in, so that
    autograd can hand it to the parameter without a copy."""
    expected = 1
    for d in sorted(range(t.dim()), key=t.stride):
        if t.size(d) == 1:
            continue
        if t.stride(d) != expected:
            return torch.empty(t.shape, device="meta").stride()
        expected *= t.size(d)
    return t.stride()


def _bwd_cuda(x4d, g_out4d, p: ResParams, stats: BatchStats, dtype,
              exchange: Optional[RankExchange] = None):
    global LAUNCHES_BWD, LAUNCHES_BWD_STAGES
    shape = _check_cuda(x4d, p, dtype)
    b, h, w, ci, ch, co = shape
    dev = x4d.device
    x = _aligned(x4d.to(dtype))
    g = _aligned(g_out4d.to(dtype))
    if g.shape != (b, h, w, co):
        raise ValueError(f"g_out {tuple(g.shape)} for output "
                         f"{(b, h, w, co)}")
    if exchange is None and b == 0:
        raise ValueError("a backward of no rows needs a data group")
    lib = _lib()
    bf = int(dtype == torch.bfloat16)
    q = _param_args(p, shape, dev)
    skip = p.skip_w is not None
    # One buffer for every f32 gradient, each weight's in the layout of its
    # parameter.
    sizes = [ci * ch, ch, 9 * ch * ch, ch, ch * co, co, ci, ci, ch, ch, ch,
             ch] + ([ci * co, co] if skip else [])
    parts = list(torch.empty(sum(sizes), device=dev).split(sizes))
    for i, t in ((0, p.w1), (2, p.w2), (4, p.w3)) + (
            ((12, p.skip_w),) if skip else ()):
        parts[i] = parts[i].as_strided(t.shape, _param_strides(t))
    grads = ResParams(*parts, *(() if skip else (None, None)))
    gx = torch.empty((b, h, w, ci), device=dev, dtype=dtype)
    scratch = _scratch(lib, 2, bf, shape, dev)
    staged, row = _stage_slots(exchange, shape, dev)
    vals = dict(
        q, **_stat_args(stats, shape, dev), **staged,
        n_global=b * h * w if exchange is None else exchange.rows * h * w,
        bf16=bf, b=b, h=h, w=w, ci=ci, ch=ch, co=co,
        x=x.data_ptr(), gout=g.data_ptr(), gx=gx.data_ptr(),
        scratch=scratch.data_ptr(),
        stream=torch.cuda.current_stream(dev).cuda_stream)
    shapes = {"w1": (ci, ch), "w2": (9, ch, ch), "w3": (ch, co),
              "skip_w": (ci, co)}
    for k, t in grads._asdict().items():
        slot = "d" + {"skip_w": "skw", "skip_b": "skb"}.get(k, k)
        if k in shapes:
            vals.update(_weight(slot, t, shapes[k], dev))
        else:
            vals[slot] = 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        if exchange is None:
            rc = lib.resmodule_backward(_slot_array(lib.bwd_slots, vals))
        else:
            rc = _run_staged(lib.resmodule_backward, lib.bwd_slots, vals,
                             row, exchange)
            LAUNCHES_BWD_STAGES += STAGES
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
    def forward(ctx, x4d, dtype, running, exchange, *params):
        p = ResParams(*params)
        with span("k3.forward"):
            if x4d.device.type == "cpu":
                out, st = res_block_ref(x4d, p, train=True, dtype=dtype,
                                        exchange=exchange)
                if running is not None:
                    b, h, w, _ = x4d.shape
                    rows = b if exchange is None else exchange.rows
                    update_running_ref(running, st, rows * h * w)
            else:
                out, st = _fwd_cuda(x4d, p, True, None, dtype, running,
                                    exchange)
        ctx.dtype = dtype
        ctx.exchange = exchange
        ctx.where = debug.where()
        debug.check((out, *st), f"K3's outputs in {ctx.where}")
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
        with span("k4.backward"):
            if x4d.device.type == "cpu":
                gx, grads = res_block_bwd_ref(x4d, g_out, p, st,
                                              dtype=ctx.dtype,
                                              exchange=ctx.exchange)
            else:
                gx, grads = _bwd_cuda(x4d, g_out, p, st, ctx.dtype,
                                      ctx.exchange)
        debug.check((gx, *grads), f"K4's outputs (g_x, gradients) in "
                                  f"{ctx.where}")
        return (gx, None, None, None, *grads)


def res_block_train(x4d: torch.Tensor, p: ResParams, *,
                    dtype=torch.bfloat16,
                    running: Optional[RunningStats] = None,
                    exchange: Optional[RankExchange] = None
                    ) -> Tuple[torch.Tensor, BatchStats]:
    """Fused train-mode forward, differentiable: (B, H, W, Ci) ->
    ((B, H, W, Co), BatchStats). ``x4d`` is cast to ``dtype`` before the
    autograd boundary, so its gradient has the working type.

    With ``running`` the three BNs' running statistics are updated IN PLACE
    by the call (torch's rule: ``r = (1 - momentum) r + momentum batch``,
    the variance unbiased by n / (n - 1), ``num_batches_tracked += 1``); on
    the card the kernel that finishes each BN's statistics writes them. The
    JAX package returns new statistics instead (``core/norm.py`` there).
    ``running.momentum`` must be a number: the cumulative average
    (``momentum=None``) stays with ``core.norm.update_running_stats``.

    ``exchange``: the data group the BN reductions span (module
    docstring); the statistics returned are then the global batch's, and
    ``running`` is updated with the global count."""
    if running is not None and running.momentum is None:
        raise ValueError("running.momentum must be a number")
    res = _ResBlockTrain.apply(x4d.to(dtype), dtype, running, exchange, *p)
    return res[0], BatchStats(*res[1:])


def res_block_eval(x4d: torch.Tensor, p: ResParams, stats: BatchStats, *,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Fused eval-mode forward with running statistics. Not differentiable
    (neither is the TPU kernel's eval call). An ``x4d`` that overrides torch
    functions (``parallel/spatial.py``'s slabs) takes the call."""
    if has_torch_function_unary(x4d):
        return handle_torch_function(res_block_eval, (x4d,), x4d, p, stats,
                                     dtype=dtype)
    with span("k3.forward"):
        if x4d.device.type == "cpu":
            return res_block_ref(x4d, p, train=False, stats=stats,
                                 dtype=dtype)[0]
        if torch.is_grad_enabled() and (x4d.requires_grad or any(
                t is not None and t.requires_grad for t in p)):
            raise RuntimeError("res_block_eval has no backward; run it "
                               "under torch.no_grad() or use "
                               "res_block_train")
        return _fwd_cuda(x4d, p, False, stats, dtype)[0]
