"""Int8 lifting forward (kernel K2): the four 1024 x 1024 hidden layers as
int8 x int8 -> int32 products, encode and decode in bf16 (counterpart of
``bilinear_tpu/ops/pallas/lifting_int8.py``).

Scheme (the JAX package's):
- weights: BN folded first, then symmetric per-output-channel int8
  (``wq[:, j] = round(W[:, j] / s_j)``, ``s_j = max|W[:, j]| / 127``);
- activations: ``s_x = max|h| / 127`` over a 512-row group (dynamic mode)
  or four calibrated constants (``calibrate_scales``, static mode);
  ``hq = clip(round_half_even(h / s_x), -127, 127)``;
- dequant: ``relu(acc * (s_x * s_w) + b)``, f32 between layers.

Dynamic groups follow the JAX path's padding: the batch is padded with
zero rows up to a group multiple, and those rows enter the last group's
amax. The plain version pads exactly so; the CUDA wrapper appends one zero
row, which gives the same amax because all padding rows are equal. In
static mode the numbers do not depend on the grouping at all.

On a CUDA tensor ``lifting_forward_int8`` launches ``csrc/lifting_int8.cu``;
on a CPU tensor it runs the plain version. There is no fallback.
"""
from __future__ import annotations

import ctypes
from math import floor, log10
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bilinear_tpu_torch.device import resolve_device
from bilinear_tpu_torch.ops import _build
from bilinear_tpu_torch.ops.lifting import (
    HIDDEN,
    IN_F,
    OUT_F,
    _f32,
    folded_layer,
    rows_for_kernel,
)

GROUP = 512  # rows per dynamic activation-scale group (the TPU kernel's tile)
STATIC_TILE = 1024  # the JAX path's static-mode tile for n >= 1024
HIDDEN_NAMES = ["bilinear_0_0", "bilinear_0_1", "bilinear_1_0", "bilinear_1_1"]
_ONE_GROUP = 1 << 30  # group_rows that puts every row in one group

# Forwards that went through the CUDA kernel chain (one per call of the C
# entry: encode, 4 x (quantize + int8 GEMM), decode).
LAUNCHES = 0

Scales = Sequence[Optional[float]]


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: (wq int8 (in, out), scale f32
    (out,))."""
    amax = w.abs().amax(dim=0)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    wq = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return wq.to(torch.int8), scale.to(torch.float32)


def prepare_weights_int8(params, batch_stats, device=None) -> Dict:
    """Fold BN, quantize the four hidden layers, keep encode/decode bf16.
    Once per checkpoint. ``device`` defaults to the card."""
    device = resolve_device(device)
    enc_w, enc_b = folded_layer(params, batch_stats, "encode", device)
    hidden = []
    for name in HIDDEN_NAMES:
        w, b = folded_layer(params, batch_stats, name, device)
        wq, ws = quantize_weight(w)
        hidden.append((wq.contiguous(), ws.contiguous(), b.contiguous()))
    return {
        "encode": (enc_w.to(torch.bfloat16).contiguous(), enc_b.contiguous()),
        "hidden": hidden,
        "decode": (
            _f32(params["decode"]["kernel"], device).to(torch.bfloat16)
            .contiguous(),
            _f32(params["decode"]["bias"], device).contiguous(),
        ),
    }


def _round_sig(x: float, digits: int = 3) -> float:
    """Round to ``digits`` significant figures, so re-calibrating after a
    hot reload usually gives the same floats."""
    if x == 0.0:
        return 0.0
    return round(x, -int(floor(log10(abs(x)))) + digits - 1)


# ---------------------------------------------------------------- plain path


def _quant_dot(h, wq, ws, b, s_x: Optional[float], amaxes: List):
    """relu((q(h) @ wq) * (s_x * s_w) + b) on (groups, rows, 1024) f32.
    ``s_x=None`` takes each group's own amax. Appends the scale used."""
    if s_x is None:
        amax = h.abs().amax(dim=(1, 2), keepdim=True)
        amaxes.append(amax.reshape(-1))
        s = torch.clamp_min(amax, 1e-12) / 127.0
    else:
        s = torch.tensor(s_x, dtype=torch.float32, device=h.device)
    hq = torch.clamp(torch.round(h / s), -127, 127)
    # |acc| <= 127 * 127 * 1024 < 2**24: the f32 product of the int-valued
    # operands is exact (with TF32 off on a card).
    acc = hq @ wq.float()
    y = acc * (s * ws) + b
    return torch.relu(y)


def forward_chain(prepared: Dict, scales: Scales, x: torch.Tensor,
                  amaxes: Optional[List] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel over row groups: ``x`` is
    (groups, rows, 32); the scale of each ``None`` entry of ``scales`` is
    the amax of each group. Returns (groups, rows, 48) f32 and, into
    ``amaxes``, the per-group amax of each dynamic layer's input."""
    amaxes = [] if amaxes is None else amaxes
    enc_w, enc_b = prepared["encode"]
    dec_w, dec_b = prepared["decode"]
    hid = prepared["hidden"]
    h = torch.relu(x.to(torch.bfloat16).float() @ enc_w.float() + enc_b)
    skip = h
    h = _quant_dot(h, *hid[0], scales[0], amaxes)
    h = _quant_dot(h, *hid[1], scales[1], amaxes) + skip
    skip = h
    h = _quant_dot(h, *hid[2], scales[2], amaxes)
    h = _quant_dot(h, *hid[3], scales[3], amaxes) + skip
    return h.to(torch.bfloat16).float() @ dec_w.float() + dec_b


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if rows == x.shape[0]:
        return x
    pad = torch.zeros((rows - x.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad], dim=0)


def lifting_forward_int8_ref(prepared: Dict, x: torch.Tensor,
                             static_scales: Optional[Scales] = None,
                             tile: Optional[int] = None) -> torch.Tensor:
    """The plain version with the JAX path's tiling: pad with zero rows to
    a tile multiple (512, or 1024 in static mode for n >= 1024), one scale
    group per tile, unpad."""
    n = x.shape[0]
    if tile is None:
        tile = STATIC_TILE if (static_scales is not None and n >= STATIC_TILE) \
            else GROUP
    xp = _pad_rows(x.to(torch.bfloat16), -(-n // tile) * tile)
    scales = (None,) * 4 if static_scales is None else tuple(static_scales)
    out = forward_chain(prepared, scales, xp.reshape(-1, tile, IN_F))
    return out.reshape(-1, OUT_F)[:n]


# ------------------------------------------------------------------ kernel

_ARGTYPES = ([ctypes.c_void_p] * 23 + [ctypes.c_float] * 4
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _lib():
    fn = _build.library("lifting_int8").lifting_int8_forward
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_weights(prepared: Dict, device) -> List[torch.Tensor]:
    flat = [*prepared["encode"]]
    for t in prepared["hidden"]:
        flat += [*t]
    flat += [*prepared["decode"]]
    want = ([((IN_F, HIDDEN), torch.bfloat16), ((HIDDEN,), torch.float32)]
            + [((HIDDEN, HIDDEN), torch.int8), ((HIDDEN,), torch.float32),
               ((HIDDEN,), torch.float32)] * 4
            + [((HIDDEN, OUT_F), torch.bfloat16), ((OUT_F,), torch.float32)])
    for t, (shape, dtype) in zip(flat, want):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"prepared weight {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("prepared weights must be contiguous, 16-byte "
                             "aligned, on the rows' device")
    return flat


def _launch(prepared: Dict, x: torch.Tensor, scales: Scales,
            group_rows: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pass of the CUDA chain over all rows of ``x`` (bf16, (m, 32)).
    Dynamic mode (all ``scales`` None) returns the per-group amax of each
    layer's input, (4, groups); static mode (all floats) returns None."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError("the int8 lifting kernel needs a CUDA tensor")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != IN_F:
        raise ValueError(f"x must be bf16 (m, {IN_F}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    dynamic = all(s is None for s in scales)
    if not dynamic and any(s is None for s in scales):
        raise ValueError("scales must be all None (dynamic) or all floats")
    if group_rows % 128:
        raise ValueError("group_rows must be a multiple of the kernel's "
                         "largest row tile, 128")
    x = rows_for_kernel(x)
    flat = _check_weights(prepared, x.device)
    m = x.shape[0]
    out = torch.empty((m, OUT_F), dtype=torch.float32, device=x.device)
    groups = -(-m // group_rows)
    amax = (torch.empty((4, groups), dtype=torch.float32, device=x.device)
            if dynamic else None)
    if m == 0:
        return out, amax
    h = torch.empty((3, m, HIDDEN), dtype=torch.float32, device=x.device)
    q = torch.empty((m, HIDDEN), dtype=torch.int8, device=x.device)
    fixed = [0.0] * 4 if dynamic else [float(s) for s in scales]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib()(
            x.data_ptr(), *[t.data_ptr() for t in flat], out.data_ptr(),
            h[0].data_ptr(), h[1].data_ptr(), h[2].data_ptr(), q.data_ptr(),
            None if amax is None else amax.data_ptr(), *fixed, m, group_rows,
            stream,
        )
    _build.check(rc, "lifting_int8_forward")
    LAUNCHES += 1
    return out, amax


def lifting_forward_int8(params=None, batch_stats=None, x=None, *,
                         prepared: Optional[Dict] = None,
                         static_scales: Optional[Scales] = None
                         ) -> torch.Tensor:
    """Eval-mode forward with int8 hidden layers, (n, 32) -> (n, 48) f32 on
    ``x``'s device. ``static_scales``: four floats from ``calibrate_scales``
    (static mode); None computes each 512-row group's scale (dynamic)."""
    if prepared is None:
        prepared = prepare_weights_int8(params, batch_stats, device=x.device)
    if x.device.type == "cpu":
        return lifting_forward_int8_ref(prepared, x, static_scales)
    n = x.shape[0]
    x = x.to(torch.bfloat16)
    if static_scales is not None:
        out, _ = _launch(prepared, x, tuple(static_scales), _ONE_GROUP)
        return out
    if n % GROUP:  # one zero row stands for the JAX path's padding rows
        x = _pad_rows(x, n + 1)
    out, _ = _launch(prepared, x, (None,) * 4, GROUP)
    return out[:n]


def calibrate_scales(prepared: Dict, x, margin: float = 1.0,
                     digits: int = 3) -> Tuple[float, ...]:
    """Static per-layer activation scales from a calibration batch (f32,
    pre-normalized rows): the dynamic forward over the WHOLE batch as one
    group records max|h| entering each quantized layer; returns four Python
    floats ``amax * margin / 127`` rounded to ``digits`` significant
    figures. On the card the kernel computes the amaxes (one group of all
    rows); on the CPU the plain version does."""
    device = prepared["encode"][0].device
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if device.type == "cpu":
        amaxes: List = []
        forward_chain(prepared, (None,) * 4, x[None], amaxes)
        a = [float(v) for v in torch.cat(amaxes)]
    else:
        _, amax = _launch(prepared, x.to(torch.bfloat16), (None,) * 4,
                          _ONE_GROUP)
        a = amax[:, 0].tolist()
    return tuple(
        _round_sig(max(v, 1e-12) * margin / 127.0, digits) for v in a
    )
