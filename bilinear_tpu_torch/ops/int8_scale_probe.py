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
(fixed, mxu: one launch per call at every n, planned by ``plan_probe``,
its weights the stream ``weight_image`` made once per checkpoint) or K2's
``_launch`` (dynamic); it refuses a CPU tensor. The plain versions
``fixed_chain_ref`` and ``mxu_chain_ref`` repeat the arithmetic for the
tests and the checks on the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from bilinear_tpu_torch.ops import _build
from bilinear_tpu_torch.ops import lifting_int8 as pq
from bilinear_tpu_torch.ops.int8 import SMS
from bilinear_tpu_torch.ops.lifting import (
    HIDDEN, IN_F, OUT_F, on_device, rows_for_kernel,
)

FIXED_SCALE = 0.05  # the probe's one activation scale, as an f32
INV_FIXED_SCALE = 1.0 / FIXED_SCALE  # 20.0: the probe multiplies by it
VARIANTS = ("dynamic", "fixed", "mxu")
_KERNEL_VARIANT = {"fixed": 0, "mxu": 1}

# Launches of csrc/int8_scale_probe.cu by variant: one per call of the C
# entry, one device kernel.
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
# One launch per call (csrc/int8_scale_probe.cu): clusters of CLUSTER
# blocks, one block per SM, each block 64 rows through all six layers, the
# weights streamed as one pre-swizzled image.

CLUSTER = 2  # blocks per cluster: one L2 read of a weight stage feeds both
BLOCK_ROWS = 64  # rows per block, one wgmma row tile
TILE_ROWS = CLUSTER * BLOCK_ROWS  # rows a cluster takes at a time
THREADS = 384  # a producer warpgroup and two consumer warpgroups
SLAB = 128  # bytes of K in a row of a weight stage
STAGE_COLS = 128  # output columns per stage, and per pass
STAGE_BYTES = STAGE_COLS * SLAB
DECODE_SLABS = STAGE_COLS * 2 // SLAB  # a pass's K of the bf16 decode
DECODE_STAGE_BYTES = DECODE_SLABS * OUT_F * SLAB
STAGES = 6  # the weight ring
ACT_BYTES = BLOCK_ROWS * HIDDEN  # one int8 activation of a block
SMEM_BYTES = 1024 + 2 * ACT_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 2) * 8
SMEM_LIMIT = 232448  # shared memory a block may use on an H100
PASSES = HIDDEN // STAGE_COLS
IMAGE_BYTES = (PASSES * STAGE_BYTES + 4 * PASSES * (HIDDEN // SLAB)
               * STAGE_BYTES + PASSES * DECODE_STAGE_BYTES)


@dataclass(frozen=True)
class ProbePlan:
    """K5's launch for n rows: ``clusters`` clusters of ``cluster`` blocks
    (the grid, at most one block per SM), each cluster taking the tiles of
    ``tile_rows`` rows k, k + clusters, ... of ``tiles``."""
    cluster: int
    clusters: int
    tiles: int
    block_rows: int
    threads: int
    smem_bytes: int

    @property
    def grid(self) -> int:
        return self.clusters * self.cluster

    @property
    def tile_rows(self) -> int:
        return self.cluster * self.block_rows

    def rows_of(self, block: int, n: int) -> List[Tuple[int, int]]:
        """The row ranges [lo, hi) that ``block`` of the grid finishes."""
        k, rank = divmod(block, self.cluster)
        out = []
        for tile in range(k, self.tiles, self.clusters):
            lo = tile * self.tile_rows + rank * self.block_rows
            if lo < n:
                out.append((lo, min(lo + self.block_rows, n)))
        return out


def plan_probe(n: int, clusters_on_card: int = SMS // CLUSTER) -> ProbePlan:
    """The plan of ``probe_forward``'s one launch over n rows: as many
    clusters as the card holds at once (``cluster_capacity``), no more than
    there are tiles. Keep in step with csrc/int8_scale_probe.cu."""
    if n < 1 or clusters_on_card < 1:
        raise ValueError(f"plan_probe: n = {n}, {clusters_on_card} clusters")
    tiles = -(-n // TILE_ROWS)
    return ProbePlan(CLUSTER, min(clusters_on_card, tiles), tiles, BLOCK_ROWS,
                     THREADS, SMEM_BYTES)


def swizzle_rows(rows: torch.Tensor) -> torch.Tensor:
    """(..., R, 128) bytes as wgmma reads them from shared memory: the
    16-byte chunk j of row r stored at chunk j ^ (r % 8) (the 128-byte
    swizzle; a stage starts at a 1024-byte boundary)."""
    r = rows.shape[-2]
    rr = torch.arange(r, device=rows.device)
    perm = torch.arange(8, device=rows.device)[None, :] ^ (rr[:, None] % 8)
    chunks = rows.reshape(*rows.shape[:-1], 8, 16)
    idx = perm[:, :, None].expand(r, 8, 16).expand(chunks.shape)
    return torch.gather(chunks, -2, idx).reshape(rows.shape)


def weight_image(prepared: Dict) -> torch.Tensor:
    """K5's weight stream: every stage the kernel multiplies, in the order
    it takes them, each the exact shared-memory image of the stage. Made
    once per checkpoint, read for every tile of 256 rows:

    - the encode: a stage for each pass of 128 output columns, each row 64
      bytes of K (32 bf16) and 64 zero bytes;
    - each hidden layer: for each pass of 128 output columns, 8 stages of
      128 bytes of K; after each pass of hidden layer 3 one decode stage:
      2 slabs of 48 rows (the outputs) x 64 bf16 of that pass's K.

    Bytes (uint8, on the weights' device), IMAGE_BYTES long."""
    enc, *hidden, dec = prepared["kmajor"]
    enc = enc.contiguous().view(torch.uint8)
    enc = torch.cat([enc, torch.zeros_like(enc)], dim=1)
    parts = [swizzle_rows(enc.reshape(PASSES, STAGE_COLS, SLAB)).reshape(-1)]
    dec = dec.contiguous().view(torch.uint8).reshape(OUT_F, PASSES,
                                                     DECODE_SLABS, SLAB)
    dec = swizzle_rows(dec.permute(1, 2, 0, 3).contiguous())
    for layer, w in enumerate(hidden):
        w = w.contiguous().view(torch.uint8).reshape(
            PASSES, STAGE_COLS, HIDDEN // SLAB, SLAB).permute(0, 2, 1, 3)
        w = swizzle_rows(w.contiguous())
        for p in range(PASSES):
            parts.append(w[p].reshape(-1))
            if layer == 3:
                parts.append(dec[p].reshape(-1))
    return torch.cat(parts)


def _image(prepared: Dict) -> torch.Tensor:
    """``weight_image``, kept on a ``PreparedInt8`` while its K-contiguous
    copies are the same objects at the same addresses (a plain dict gets a
    new one at every call)."""
    src = list(prepared["kmajor"])
    ptrs = [t.data_ptr() for t in src]
    held = getattr(prepared, "probe_image", None)
    if held is not None and held[1] == ptrs and all(
            a is b for a, b in zip(held[0], src)):
        return held[2]
    image = weight_image(prepared)
    if hasattr(prepared, "__dict__"):
        prepared.probe_image = (tuple(src), ptrs, image)
    return image


_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_fn = None
_capacity: Dict[int, int] = {}


def _lib():
    global _fn
    if _fn is None:
        fn = _build.library("int8_scale_probe").int8_scale_probe_forward
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def cluster_capacity(device: torch.device) -> int:
    """Clusters of K5's kernel that ``device`` holds at once (asked once
    per device)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _capacity:
        fn = _build.library("int8_scale_probe").int8_scale_probe_clusters
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        got = ctypes.c_int(0)
        with on_device(torch.device("cuda", index)):
            _build.check(fn(ctypes.byref(got)), "int8_scale_probe_clusters")
        if got.value < 1:
            raise RuntimeError("the card holds no cluster of K5's kernel")
        _capacity[index] = got.value
    return _capacity[index]


def _launch(prepared: Dict, x: torch.Tensor, variant: str,
            activations: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """One call of the C entry (one launch) on bf16 rows ``x`` (m, 32).
    Returns the output and, with ``activations``, copies of the kernel's
    activations: ``"q"``, each hidden layer's int8 input, and
    ``"decode_input"`` (bf16); without, none is stored."""
    m = x.shape[0]
    w = pq._weight_pointers(prepared, x.device)
    enc_b, dec_b = w[1], w[15]
    ws_b = [w[i] for i in (3, 4, 6, 7, 9, 10, 12, 13)]
    out = torch.empty((m, OUT_F), dtype=torch.float32, device=x.device)
    acts: Dict[str, object] = {}
    if activations:
        q = torch.empty((4, m, HIDDEN), dtype=torch.int8, device=x.device)
        hb = torch.empty((m, HIDDEN), dtype=torch.bfloat16, device=x.device)
        acts = {"q": list(q), "decode_input": hb}
        copies = [t.data_ptr() for t in q] + [hb.data_ptr()]
    else:
        copies = [None] * 5
    if m == 0:
        return out, acts
    image = _image(prepared)
    plan = plan_probe(m, cluster_capacity(x.device))
    skip = None
    if variant == "fixed":
        skip = torch.empty((plan.grid, BLOCK_ROWS, HIDDEN),
                           dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with on_device(x.device):
        rc = _lib()(x.data_ptr(), image.data_ptr(), enc_b, *ws_b, dec_b,
                    out.data_ptr(),
                    None if skip is None else skip.data_ptr(), *copies,
                    FIXED_SCALE, INV_FIXED_SCALE, _KERNEL_VARIANT[variant], m,
                    plan.clusters, stream)
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
    out, acts = _launch(prepared, xb, variant, activations)
    return (out, acts) if activations else out
