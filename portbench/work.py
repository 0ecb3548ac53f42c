"""The benchmark's own arithmetic: the work of each model from its
configuration's shapes, NVIDIA's published H100 SXM peaks, and the least
time a kernel could take. It reads the same whatever kernel implements the
work.

``lift_bound_ms`` is ``chip_smoke.py::bound`` and ``res_bound_ms`` is
``chip_smoke.py::res_bound``, which put every precision's work on the bf16
peak; here each precision has its own.
"""
from __future__ import annotations

from typing import List, Tuple

# Dense rates without sparsity, at the 700 W limit (H100 SXM data sheet).
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "f32": 67e12, "int8": 1979e12, "fp8": 1979e12}
ITEMSIZE = {"bf16": 2, "fp16": 2, "f32": 4, "tf32": 4, "int8": 1, "fp8": 1}
HBM_BYTES_PER_S = 3.35e12


# ------------------------------------------------------------------ lifter
def lifter_macs(cfg: dict) -> int:
    """Multiply-adds per pose: encode, 2 x num_layers hidden, decode."""
    i, h, o = cfg["input_size"], cfg["linear_size"], cfg["output_size"]
    return i * h + 2 * cfg["num_layers"] * h * h + h * o


def lift_bound_ms(cfg: dict, precision: str, n: int) -> Tuple[float, str]:
    """Least time (ms) of the lifter on ``n`` rows: the larger of the bytes
    it must move (rows in, in ``precision``, and out in f32; weights in
    ``precision`` and f32 biases once) over HBM bandwidth and its
    operations over the precision's peak."""
    i, h, o = cfg["input_size"], cfg["linear_size"], cfg["output_size"]
    item = ITEMSIZE[precision]
    rows = n * (i * item + o * 4)
    hidden = 2 * cfg["num_layers"]
    weights = item * lifter_macs(cfg) + 4 * ((hidden + 1) * h + o)
    ops_s = 2 * n * lifter_macs(cfg) / PEAK_FLOPS[precision]
    bytes_s = (rows + weights) / HBM_BYTES_PER_S
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s > ops_s
                                       else "operations")


# ---------------------------------------------------------------- detector
def resmodule_shapes(cfg: dict, batch: int) -> List[tuple]:
    """(B, H, W, Ci, Co) of every ResModule of one detector forward, in
    order: three in the stem, then per stack the hourglass's."""
    r0 = cfg["inputRes"] // 2
    c0, c1, f = cfg["stem_channels"], cfg["stem_res_channels"], cfg["nFeats"]
    out = [(batch, r0, r0, c0, c1), (batch, r0 // 2, r0 // 2, c1, c1),
           (batch, r0 // 2, r0 // 2, c1, f)]

    def hourglass(r: int, depth: int) -> None:
        out.append((batch, r, r, f, f))              # res1
        out.append((batch, r // 2, r // 2, f, f))    # res2
        if depth > 1:
            hourglass(r // 2, depth - 1)
        else:
            out.append((batch, r // 2, r // 2, f, f))  # waist
        out.append((batch, r // 2, r // 2, f, f))    # res3

    for _ in range(cfg["nStack"]):
        hourglass(cfg["outputRes"], cfg["depth"])
    return out


def resmodule_macs(shape: tuple) -> int:
    b, h, w, ci, co = shape
    ch = co // 2
    return b * h * w * (ci * ch + 9 * ch * ch + ch * co
                        + (ci * co if ci != co else 0))


def detector_macs(cfg: dict) -> int:
    """Multiply-adds of one frame through the detector's convolutions."""
    r0, r = cfg["inputRes"] // 2, cfg["outputRes"]
    f, j, s = cfg["nFeats"], cfg["nParts"], cfg["nStack"]
    stem = r0 * r0 * 7 * 7 * 3 * cfg["stem_channels"]
    res = sum(resmodule_macs(sh) for sh in resmodule_shapes(cfg, 1))
    heads = s * r * r * (f * f + f * j) + (s - 1) * r * r * (f * f + j * f)
    return stem + res + heads


def end2end_flops(cfg: dict) -> int:
    """Operations of one frame through End2End (2 per multiply-add)."""
    return 2 * (detector_macs(cfg) + lifter_macs(cfg["lifter"]))


def res_bound_ms(shape: tuple, kind: str, precision: str
                 ) -> Tuple[float, str]:
    """Least time (ms) of one ResModule call: operations at the
    precision's peak vs bytes at HBM bandwidth. Forward (either mode):
    2N(Ci Ch + 9 Ch^2 + Ch Co [+ Ci Co]) against N (Ci + Co) values;
    backward twice the operations against N (2 Ci + 2 Co)."""
    b, h, w, ci, co = shape
    n = b * h * w
    macs = resmodule_macs(shape)
    item = ITEMSIZE[precision]
    if kind == "bwd":
        ops, nbytes = 4 * macs, n * (2 * ci + 2 * co) * item
    else:
        ops, nbytes = 2 * macs, n * (ci + co) * item
    ops_s, bytes_s = ops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def detector_res_bound_ms(cfg: dict, batch: int, kind: str,
                          precision: str) -> float:
    """Summed bound of every ResModule of one forward (or backward)."""
    return sum(res_bound_ms(sh, kind, precision)[0]
               for sh in resmodule_shapes(cfg, batch))
