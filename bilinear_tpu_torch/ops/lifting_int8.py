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

The kernel multiplies with int8 ``wgmma``, which reads both operands
K-contiguous: ``prepare_weights_int8`` keeps an (out, in) copy of each
weight under ``"kmajor"`` beside the (in, out) ones the plain version
reads. In static mode the kernel quantises each activation where it is
produced, with the next layer's scale: the same numbers as quantising
where it is consumed (``quantize_activation`` is that one expression).
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
    check_if_changed,
    choose_path,
    on_device,
    folded_layer,
    rows_for_kernel,
)

GROUP = 512  # rows per dynamic activation-scale group (the TPU kernel's tile)
STATIC_TILE = 1024  # the JAX path's static-mode tile for n >= 1024
HIDDEN_NAMES = ["bilinear_0_0", "bilinear_0_1", "bilinear_1_0", "bilinear_1_1"]
_ONE_GROUP = 1 << 30  # group_rows that puts every row in one group

# Forwards that went through the CUDA kernels (one per call of the C entry:
# the one serving kernel, or encode, 4 int8 GEMMs and decode).
LAUNCHES = 0

Scales = Sequence[Optional[float]]


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: (wq int8 (in, out), scale f32
    (out,))."""
    amax = w.abs().amax(dim=0)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    wq = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return wq.to(torch.int8), scale.to(torch.float32)


class PreparedInt8(dict):
    """The prepared form: ``"encode"`` and ``"decode"`` (kernel bf16 (in,
    out), bias f32), ``"hidden"`` (four (wq int8 (in, out), scale f32, bias
    f32)) and ``"kmajor"``. ``checked`` is the wrapper's note of the tensors
    it has validated (``ops.lifting.check_if_changed``)."""

    checked: Optional[Tuple] = None


def prepare_weights_int8(params, batch_stats, device=None) -> PreparedInt8:
    """Fold BN, quantize the four hidden layers, keep encode/decode bf16.
    Once per checkpoint. ``device`` defaults to the card. ``"kmajor"``
    holds the K-contiguous (out, in) copies the kernel reads: encode, the
    four ``wq``, decode."""
    device = resolve_device(device)
    enc_w, enc_b = folded_layer(params, batch_stats, "encode", device)
    hidden = []
    for name in HIDDEN_NAMES:
        w, b = folded_layer(params, batch_stats, name, device)
        wq, ws = quantize_weight(w)
        hidden.append((wq.contiguous(), ws.contiguous(), b.contiguous()))
    prepared = PreparedInt8({
        "encode": (enc_w.to(torch.bfloat16).contiguous(), enc_b.contiguous()),
        "hidden": hidden,
        "decode": (
            _f32(params["decode"]["kernel"], device).to(torch.bfloat16)
            .contiguous(),
            _f32(params["decode"]["bias"], device).contiguous(),
        ),
    })
    prepared["kmajor"] = [
        w.t().contiguous() for w in (prepared["encode"][0],
                                     *(h[0] for h in hidden),
                                     prepared["decode"][0])
    ]
    return prepared


def _round_sig(x: float, digits: int = 3) -> float:
    """Round to ``digits`` significant figures, so re-calibrating after a
    hot reload usually gives the same floats."""
    if x == 0.0:
        return 0.0
    return round(x, -int(floor(log10(abs(x)))) + digits - 1)


# ---------------------------------------------------------------- plain path


def quantize_activation(h: torch.Tensor, s) -> torch.Tensor:
    """``clip(round_half_even(h / s), -127, 127)`` as f32 integers: true
    division. The kernel's static mode applies it where ``h`` is produced
    (with the consuming layer's ``s``), the plain version where it is
    consumed."""
    return torch.clamp(torch.round(h / s), -127, 127)


def _quant_dot(h, wq, ws, b, s_x: Optional[float], amaxes: List):
    """relu((q(h) @ wq) * (s_x * s_w) + b) on (groups, rows, 1024) f32.
    ``s_x=None`` takes each group's own amax. Appends the scale used."""
    if s_x is None:
        amax = h.abs().amax(dim=(1, 2), keepdim=True)
        amaxes.append(amax.reshape(-1))
        s = torch.clamp_min(amax, 1e-12) / 127.0
    else:
        s = torch.tensor(s_x, dtype=torch.float32, device=h.device)
    hq = quantize_activation(h, s)
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

_ARGTYPES = ([ctypes.c_void_p] * 25 + [ctypes.c_float] * 4
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def needs_quantize_pass(m: int, group_rows: int, capacity_rows: int) -> bool:
    """Whether a dynamic-mode call of the per-layer path on ``m`` rows in
    groups of ``group_rows`` runs a quantise pass before each hidden layer.
    Without one a producing layer quantises its own output once its scale
    group is whole, for which the card must hold every tile of a group at
    once: ``capacity_rows`` is the largest group it takes
    (``group_capacity``). Served batches (512-row groups) never need the
    pass; a calibration batch run as one group does beyond that size."""
    return min(m, group_rows) > capacity_rows


def dynamic_launches(m: int, quantize_pass: bool = False) -> int:
    """Device launches of one dynamic-mode call on ``m`` rows: the memset
    of its scratch and one kernel, or on the per-layer path six GEMMs (four
    of which quantise their own output once their scale group is whole) or,
    with ``quantize_pass``, six GEMMs and four quantise passes."""
    if m <= 0:
        return 0
    if choose_path(m) == "fused":
        return 2
    return 1 + 6 + (4 if quantize_pass else 0)


_capacity: Dict[int, int] = {}


def group_capacity(device: torch.device) -> int:
    """Most rows of one scale group whose tiles ``device`` holds at once,
    as the kernel library reports it (asked once per device)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _capacity:
        fn = _build.library("lifting_int8").lifting_int8_group_capacity
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        rows = ctypes.c_int(0)
        with on_device(torch.device("cuda", index)):
            _build.check(fn(ctypes.byref(rows)), "lifting_int8_group_capacity")
        _capacity[index] = rows.value
    return _capacity[index]


def dynamic_scratch(m: int, group_rows: int) -> Tuple[int, Tuple[int, ...]]:
    """Dynamic mode's scratch for ``m`` rows: (groups, shape of one f32
    tensor). Plane 0 is the (4, groups) amax of each hidden layer's input;
    plane 1, read as 32-bit counters, the finished tiles per layer and
    group. The kernel entry zeroes both with one memset."""
    groups = -(-m // group_rows)
    return groups, (2, 4, groups)


_fn = None


def _lib():
    global _fn
    if _fn is None:
        fn = _build.library("lifting_int8").lifting_int8_forward
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _weight_pointers(prepared: Dict, device) -> List[int]:
    """Addresses of the prepared tensors in the C entry's order, each
    weight's K-contiguous copy in its place; validated first."""
    flat = [*prepared["encode"]]
    for t in prepared["hidden"]:
        flat += [*t]
    flat += [*prepared["decode"]]
    kmajor = list(prepared.get("kmajor") or [])
    if len(kmajor) != 6:
        raise ValueError("prepared weights lack their K-contiguous copies: "
                         "make them with prepare_weights_int8")
    check_if_changed(prepared, flat + kmajor, device,
                     lambda: _check_weights(flat + kmajor, device))
    for i, wt in zip((0, 2, 5, 8, 11, 14), kmajor):
        flat[i] = wt
    return [t.data_ptr() for t in flat]


def _check_weights(tensors: List[torch.Tensor], device) -> None:
    """``tensors``: the prepared form flattened, then its six K-contiguous
    copies."""
    want = ([((IN_F, HIDDEN), torch.bfloat16), ((HIDDEN,), torch.float32)]
            + [((HIDDEN, HIDDEN), torch.int8), ((HIDDEN,), torch.float32),
               ((HIDDEN,), torch.float32)] * 4
            + [((HIDDEN, OUT_F), torch.bfloat16), ((OUT_F,), torch.float32)]
            + [((HIDDEN, IN_F), torch.bfloat16)]
            + [((HIDDEN, HIDDEN), torch.int8)] * 4
            + [((OUT_F, HIDDEN), torch.bfloat16)])
    if len(tensors) != len(want):
        raise ValueError(f"{len(tensors)} prepared tensors, expected "
                         f"{len(want)}")
    for t, (shape, dtype) in zip(tensors, want):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"prepared weight {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("prepared weights must be contiguous, 16-byte "
                             "aligned, on the rows' device")


def _launch(prepared: Dict, x: torch.Tensor, scales: Scales,
            group_rows: int, path: Optional[str] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One pass of the CUDA kernels over all rows of ``x`` (bf16, (m, 32)).
    Dynamic mode (all ``scales`` None) returns the per-group amax of each
    layer's input, (4, groups); static mode (all floats) returns None.
    ``path`` ("fused" or "layers") overrides ``choose_path``, to time both
    sides of their boundary."""
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
    weight_ptrs = _weight_pointers(prepared, x.device)
    m = x.shape[0]
    out = torch.empty((m, OUT_F), dtype=torch.float32, device=x.device)
    scratch = (torch.empty(dynamic_scratch(m, group_rows)[1],
                           dtype=torch.float32, device=x.device)
               if dynamic else None)
    amax = scratch[0] if dynamic else None
    if m == 0:
        return out, amax
    if path is None:
        path = choose_path(m)
    if path not in ("fused", "layers"):
        raise ValueError(f"no kernel path {path!r}")
    # One allocation: h0..h2 (f32), q0, q1 (int8) and hb (bf16), each
    # (m, 1024) and a multiple of 1024 bytes long.
    row = m * HIDDEN
    work = torch.empty(row * (3 * 4 + 2 + 2), dtype=torch.uint8,
                       device=x.device)
    base = work.data_ptr()
    offsets = [0, 4 * row, 8 * row, 12 * row, 13 * row, 14 * row]
    fixed = [0.0] * 4 if dynamic else [float(s) for s in scales]
    quantize_pass = dynamic and path == "layers" and needs_quantize_pass(
        m, group_rows, group_capacity(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with on_device(x.device):
        rc = _lib()(
            x.data_ptr(), *weight_ptrs, out.data_ptr(),
            *[base + o for o in offsets],
            None if scratch is None else scratch.data_ptr(), *fixed, m,
            group_rows, int(path == "fused"), int(quantize_pass), stream,
        )
    _build.check(rc, "lifting_int8_forward")
    LAUNCHES += 1
    return out, amax


def quantize_rows_cuda(h: torch.Tensor, amax: torch.Tensor,
                       group_rows: int) -> torch.Tensor:
    """The kernel's quantise pass alone: ``h`` (m, 1024) f32 on the card to
    int8, each group of ``group_rows`` rows with the scale ``amax[g] / 127``
    (the arithmetic of every quantisation in the kernel; ``chip_smoke.py``
    holds it bit for bit against ``quantize_activation``)."""
    if h.device.type != "cuda" or h.dtype != torch.float32 \
            or h.dim() != 2 or h.shape[1] != HIDDEN:
        raise ValueError("h must be a CUDA f32 (m, 1024) tensor")
    h = rows_for_kernel(h)
    m = h.shape[0]
    amax = amax.to(device=h.device, dtype=torch.float32).contiguous()
    if amax.numel() != -(-m // group_rows):
        raise ValueError("one amax per group")
    q = torch.empty((m, HIDDEN), dtype=torch.int8, device=h.device)
    if m:
        fn = _build.library("lifting_int8").lifting_int8_quantize
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with on_device(h.device):
            rc = fn(h.data_ptr(), q.data_ptr(), amax.data_ptr(), m,
                    group_rows,
                    torch.cuda.current_stream(h.device).cuda_stream)
        _build.check(rc, "lifting_int8_quantize")
    return q


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
    if static_scales is not None:
        out, _ = _launch(prepared, x.to(torch.bfloat16), tuple(static_scales),
                         _ONE_GROUP)
        return out
    if n % GROUP:  # one zero row stands for the JAX path's padding rows
        xp = torch.zeros((n + 1, IN_F), dtype=torch.bfloat16, device=x.device)
        xp[:n] = x  # casts as it copies
        x = xp
    out, _ = _launch(prepared, x.to(torch.bfloat16), (None,) * 4, GROUP)
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
