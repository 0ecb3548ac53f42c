"""The int8 scale probe's chains (kernel K5): K2's int8 lifting forward with
its activation-scale work changed, to measure what that work costs
(counterpart of ``benchmarks/int8_scale_probe.py``).

Three variants, each (n, 32) -> (n, 48) f32 on the prepared weights of
``ops/lifting_int8.prepare_weights_int8``:

- ``"dynamic"``: K2 itself, one scale per group of ``group_rows`` rows
  (the probe's tile); a partial last group is padded with zero rows as
  ``lifting_forward_int8`` pads it (one zero row stands for them), so its
  plain version is ``lifting_forward_int8_ref(prepared, x, tile=group_rows)``.
- ``"fixed"``: K2's static chain with one constant scale ``FIXED_SCALE``
  for all four hidden layers, quantised by a product with
  ``INV_FIXED_SCALE`` (20.0 as an f32), not K2's true division:
  ``clip(rint(h * 20), -127, 127)``, then ``relu(acc * (0.05 * ws) + b)``.
- ``"mxu"``: the chain's products with no scale math: encode without ReLU,
  a saturating convert to int8 (``saturate_int8``: XLA's f32 -> int8,
  truncated toward zero, saturated to [-128, 127], NaN to 0), four int8
  products each wrapped to int8 modulo 256 (``wrap_int8``: the int32 ->
  int8 convert of both frameworks), then the bf16 decode. It bounds the
  chain; its numbers mean nothing.

On a CUDA tensor ``probe_forward`` launches ``csrc/int8_scale_probe.cu``
(fixed, mxu) or K2's ``_launch`` (dynamic); it refuses a CPU tensor. The
plain versions ``fixed_chain_ref`` and ``mxu_chain_ref`` repeat the
arithmetic for the tests and the checks on the card.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from bilinear_tpu_torch.ops import _build
from bilinear_tpu_torch.ops import lifting_int8 as pq
from bilinear_tpu_torch.ops.lifting import (
    HIDDEN, IN_F, OUT_F, on_device, rows_for_kernel,
)

FIXED_SCALE = 0.05  # the probe's one activation scale, as an f32
INV_FIXED_SCALE = 1.0 / FIXED_SCALE  # 20.0: the probe multiplies by it
VARIANTS = ("dynamic", "fixed", "mxu")
_KERNEL_VARIANT = {"fixed": 0, "mxu": 1}

# Launches of csrc/int8_scale_probe.cu by variant: one per call of the C
# entry (six GEMMs).
LAUNCHES = {"fixed": 0, "mxu": 0}


# ---------------------------------------------------------------- plain path


def saturate_int8(v: torch.Tensor) -> torch.Tensor:
    """f32 -> int8 as XLA converts: truncated toward zero, saturated to
    [-128, 127], NaN to 0 (torch's own ``.to(torch.int8)`` wraps)."""
    t = torch.clamp(torch.trunc(v), -128, 127)
    return torch.where(torch.isnan(v), torch.zeros_like(t), t).to(torch.int8)


def wrap_int8(acc: torch.Tensor) -> torch.Tensor:
    """Integer values -> int8 modulo 256 (the int32 -> int8 convert)."""
    low = acc.to(torch.int64) & 0xFF
    return (low - ((low & 0x80) << 1)).to(torch.int8)


def quantize_fixed(h: torch.Tensor) -> torch.Tensor:
    """``clip(rint(h * 20), -127, 127)`` as int8: a product with the f32
    constant, as the probe writes it."""
    return torch.clamp(torch.round(h * INV_FIXED_SCALE), -127, 127) \
        .to(torch.int8)


def _encode(prepared: Dict, x: torch.Tensor) -> torch.Tensor:
    enc_w, enc_b = prepared["encode"]
    return x.to(torch.bfloat16).float() @ enc_w.float() + enc_b


def _decode(prepared: Dict, h: torch.Tensor) -> torch.Tensor:
    dec_w, dec_b = prepared["decode"]
    return h.to(torch.bfloat16).float() @ dec_w.float() + dec_b


def fixed_chain_ref(prepared: Dict, x: torch.Tensor,
                    activations: Optional[List] = None) -> torch.Tensor:
    """Plain version of the fixed chain: (n, 32) -> (n, 48) f32. Appends
    each hidden layer's int8 input to ``activations``."""
    acts = [] if activations is None else activations

    def quant_dot(h, wq, ws, b):
        hq = quantize_fixed(h)
        acts.append(hq)
        # |acc| <= 127 * 127 * 1024 < 2**24: exact in f32.
        acc = hq.float() @ wq.float()
        return torch.relu(acc * (FIXED_SCALE * ws) + b)

    hid = prepared["hidden"]
    h = torch.relu(_encode(prepared, x))
    skip = h
    h = quant_dot(h, *hid[0])
    h = quant_dot(h, *hid[1]) + skip
    skip = h
    h = quant_dot(h, *hid[2])
    h = quant_dot(h, *hid[3]) + skip
    return _decode(prepared, h)


def mxu_hidden_ref(prepared: Dict, hq: torch.Tensor,
                   activations: Optional[List] = None) -> torch.Tensor:
    """The mxu chain from its first int8 activation ``hq`` (n, 1024) on:
    four wrapped int8 products, then the decode. Appends the input of each
    hidden layer and, last, the decode's int8 input to ``activations``."""
    acts = [] if activations is None else activations
    for wq, _, _ in prepared["hidden"]:
        acts.append(hq)
        # |acc| <= 128 * 127 * 1024 < 2**24: exact in f32.
        hq = wrap_int8(hq.float() @ wq.float())
    acts.append(hq)
    return _decode(prepared, hq.float())


def mxu_chain_ref(prepared: Dict, x: torch.Tensor,
                  activations: Optional[List] = None) -> torch.Tensor:
    """Plain version of the mxu chain: (n, 32) -> (n, 48) f32."""
    return mxu_hidden_ref(prepared, saturate_int8(_encode(prepared, x)),
                          activations)


# ------------------------------------------------------------------ kernel

_ARGTYPES = ([ctypes.c_void_p] * 25 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_fn = None


def _lib():
    global _fn
    if _fn is None:
        fn = _build.library("int8_scale_probe").int8_scale_probe_forward
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(prepared: Dict, x: torch.Tensor, variant: str
            ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """One call of the C entry on bf16 rows ``x`` (m, 32). Returns the
    output and the activations: ``"q"``, each hidden layer's int8 input,
    and ``"decode_input"`` (bf16)."""
    m = x.shape[0]
    weight_ptrs = pq._weight_pointers(prepared, x.device)
    out = torch.empty((m, OUT_F), dtype=torch.float32, device=x.device)
    h = torch.empty((2, m, HIDDEN), dtype=torch.float32, device=x.device)
    q = torch.empty((4, m, HIDDEN), dtype=torch.int8, device=x.device)
    hb = torch.empty((m, HIDDEN), dtype=torch.bfloat16, device=x.device)
    acts = {"q": list(q), "decode_input": hb}
    if m == 0:
        return out, acts
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with on_device(x.device):
        rc = _lib()(x.data_ptr(), *weight_ptrs, out.data_ptr(),
                    h[0].data_ptr(), h[1].data_ptr(),
                    *[t.data_ptr() for t in q], hb.data_ptr(), FIXED_SCALE,
                    INV_FIXED_SCALE, _KERNEL_VARIANT[variant], m, stream)
    _build.check(rc, "int8_scale_probe_forward")
    LAUNCHES[variant] += 1
    return out, acts


def probe_forward(prepared: Dict, x: torch.Tensor, variant: str,
                  group_rows: int = pq.GROUP, activations: bool = False):
    """The probe's chain ``variant`` over the rows ``x`` (n, 32), on the
    card: (n, 48) f32. ``group_rows`` sets the dynamic variant's scale
    groups (a multiple of 128). With ``activations`` also returns the
    kernel's activations (``_launch``; dynamic: ``{"amax"}``, the (4,
    groups) amax of each hidden layer's input)."""
    if variant not in VARIANTS:
        raise ValueError(f"no probe variant {variant!r}: one of {VARIANTS}")
    if x.device.type != "cuda":
        raise ValueError("the int8 scale probe's kernels need a CUDA tensor")
    if x.dim() != 2 or x.shape[1] != IN_F:
        raise ValueError(f"x must be (n, {IN_F}), got {tuple(x.shape)}")
    xb = rows_for_kernel(x.to(torch.bfloat16))
    if variant == "dynamic":
        n = xb.shape[0]
        if n % group_rows:  # one zero row stands for the padding rows
            xb = pq._pad_rows(xb, n + 1)
        out, amax = pq._launch(prepared, xb, (None,) * 4, group_rows)
        return (out[:n], {"amax": amax}) if activations else out[:n]
    out, acts = _launch(prepared, xb, variant)
    return (out, acts) if activations else out
