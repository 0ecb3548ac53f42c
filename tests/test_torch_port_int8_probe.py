"""The int8 scale probe's plain versions (bilinear_tpu_torch/ops/
int8_scale_probe.py, kernel K5's) against the probe's own bodies in
benchmarks/int8_scale_probe.py, run by ``pl.pallas_call(...,
interpret=True)`` with ``_run``'s BlockSpecs (that file is loaded by path
and not changed), and the dynamic variant against
``lifting_int8._run_pallas(..., interpret=True)``. n = 1024 rows in tiles
of 512 (256 and 1024 for the dynamic sweep), full-width layers.

Tolerances: fixed and dynamic as K2's (tests/test_torch_port_int8.py
``_gate``: the bf16 encode sums in another order, so an activation at a
rounding boundary moves one int8 step now and then: mean |diff| below
2e-3 and the 99th percentile below 2e-2 of mean |ref|). mxu bit for bit on
dyadic inputs, where every sum is exact in f32 in any order: x in {k/4 :
|k| <= 16}, encode and decode weights in {j/16 : |j| <= 16}, biases in
{i/8 : |i| <= 16} (encode sums at most 14 significant bits, decode sums
at most 22)."""
import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bilinear_tpu.ops.pallas import lifting_int8 as jq
from bilinear_tpu_torch.ops import int8_scale_probe as kp
from bilinear_tpu_torch.ops import lifting_int8 as pq
from torch_port_fixtures import one_torch_thread, rows, scrambled_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, TILE = 1024, 512


def _load_probe():
    spec = importlib.util.spec_from_file_location(
        "int8_scale_probe", os.path.join(ROOT, "benchmarks",
                                         "int8_scale_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


probe = _load_probe()


def _run_interpret(kernel, x, flat, tile=TILE):
    """``benchmarks/int8_scale_probe.py::_run`` with ``interpret=True``."""
    n = x.shape[0]

    def w_spec(shape):
        return pl.BlockSpec(shape, lambda i: (0,) * len(shape),
                            memory_space=pltpu.VMEM)

    in_specs = [pl.BlockSpec((tile, 32), lambda i: (i, 0),
                             memory_space=pltpu.VMEM)]
    in_specs += [w_spec(w.shape) for w in flat]
    return np.asarray(pl.pallas_call(
        kernel, grid=(n // tile,), in_specs=in_specs,
        out_specs=pl.BlockSpec((tile, 48), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, 48), jnp.float32),
        interpret=True)(x, *flat))


def _gate(out, ref):
    scale = np.abs(ref).mean()
    d = np.abs(np.asarray(out) - np.asarray(ref))
    assert np.isfinite(out).all()
    assert d.mean() < 2e-3 * scale, d.mean()
    assert np.percentile(d, 99) < 2e-2 * scale, np.percentile(d, 99)


@pytest.fixture(scope="module")
def variables():
    params, stats = scrambled_variables(0)
    return (jq.prepare_weights_int8(params, stats),
            pq.prepare_weights_int8(params, stats, device="cpu"))


def _dyadic(seed):
    """Both packages' prepared weights with dyadic encode and decode (the
    hidden layers: the random model's int8 weights) and dyadic rows."""
    params, stats = scrambled_variables(1)
    jp = jq.prepare_weights_int8(params, stats)
    rs = np.random.RandomState(seed)
    enc_w = rs.randint(-16, 17, (32, 1024)).astype(np.float32) / 16
    enc_b = rs.randint(-16, 17, 1024).astype(np.float32) / 8
    dec_w = rs.randint(-16, 17, (1024, 48)).astype(np.float32) / 16
    dec_b = rs.randint(-16, 17, 48).astype(np.float32) / 8
    x = rs.randint(-16, 17, (N, 32)).astype(np.float32) / 4
    # Rows 0 and 1 drive channels 0 and 1 past int8's range (+-130).
    enc_w[:, :2], enc_b[:2] = [1.0, -1.0], [2.0, -2.0]
    x[0], x[1] = 4.0, -4.0
    jp = dict(jp, encode=(jnp.asarray(enc_w, jnp.bfloat16),
                          jnp.asarray(enc_b)),
              decode=(jnp.asarray(dec_w, jnp.bfloat16), jnp.asarray(dec_b)))
    tp = pq.prepare_weights_int8(params, stats, device="cpu")
    tp["encode"] = (torch.from_numpy(enc_w).to(torch.bfloat16),
                    torch.from_numpy(enc_b))
    tp["decode"] = (torch.from_numpy(dec_w).to(torch.bfloat16),
                    torch.from_numpy(dec_b))
    return jp, tp, x


def test_fixed_matches_the_probe(variables):
    jp, tp = variables
    x = rows(N, 7)
    ref = _run_interpret(probe._kernel_fixed,
                         jnp.asarray(x).astype(jnp.bfloat16),
                         jq._flatten(jp))
    out = kp.fixed_chain_ref(tp, torch.from_numpy(x)).numpy()
    assert out.shape == (N, 48)
    _gate(out, ref)


@pytest.mark.parametrize("seed", [3, 4])
def test_mxu_matches_the_probe_bit_for_bit_on_dyadic_inputs(seed):
    jp, tp, x = _dyadic(seed)
    ref = _run_interpret(probe._kernel_mxu,
                         jnp.asarray(x).astype(jnp.bfloat16),
                         jq._flatten(jp))
    acts = []
    out = kp.mxu_chain_ref(tp, torch.from_numpy(x), acts).numpy()
    np.testing.assert_array_equal(out, ref)
    # Not a degenerate chain: every activation takes many values, the
    # first one saturates at both ends and the later ones wrap.
    assert len(acts) == 5
    for a in acts:
        assert len(torch.unique(a)) >= 16
    assert acts[0][0, 0] == 127 and acts[0][0, 1] == -128
    for a in acts[1:]:
        assert int(a.min()) < -100 and int(a.max()) > 100


def test_fixed_on_dyadic_inputs_matches_the_probe():
    """On the dyadic inputs the encode is exact, so the first activation is
    the same on both sides; the output meets K2 static's gates."""
    jp, tp, x = _dyadic(5)
    ref = _run_interpret(probe._kernel_fixed,
                         jnp.asarray(x).astype(jnp.bfloat16),
                         jq._flatten(jp))
    acts = []
    out = kp.fixed_chain_ref(tp, torch.from_numpy(x), acts).numpy()
    _gate(out, ref)
    h = jnp.maximum(jnp.dot(jnp.asarray(x).astype(jnp.bfloat16),
                            jp["encode"][0],
                            preferred_element_type=jnp.float32)
                    + jp["encode"][1], 0.0)
    jq0 = jnp.clip(jnp.round(h * (1.0 / probe.FIXED_SCALE)), -127, 127)
    np.testing.assert_array_equal(acts[0].numpy(),
                                  np.asarray(jq0).astype(np.int8))


@pytest.mark.parametrize("group", [256, 1024])
def test_dynamic_matches_run_pallas(variables, group):
    """The dynamic rows' plain version, K2's with the probe's tile."""
    jp, tp = variables
    x = rows(N, 8)
    ref = np.asarray(jq._run_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                                    jq._flatten(jp), interpret=True,
                                    tile=group))
    out = pq.lifting_forward_int8_ref(tp, torch.from_numpy(x),
                                      tile=group).numpy()
    _gate(out, ref)


@pytest.mark.parametrize("value, want", [
    (300.7, 127), (-300.7, -128), (127.9, 127), (-128.9, -128),
    (float("nan"), 0), (float("inf"), 127), (-0.9, 0), (5.99, 5)])
def test_saturating_convert_is_xlas(value, want):
    """f32 -> int8 as JAX converts (``h.astype(jnp.int8)``): truncation,
    saturation, NaN to 0; torch's own cast wraps instead."""
    v = np.float32(value)
    assert int(np.asarray(jnp.asarray(v).astype(jnp.int8))) == want
    assert int(kp.saturate_int8(torch.tensor([v]))[0]) == want


def test_torch_cast_wraps_where_xla_saturates():
    assert int(torch.tensor([300.7]).to(torch.int8)[0]) == 44
    assert int(kp.saturate_int8(torch.tensor([300.7]))[0]) == 127


@pytest.mark.parametrize("value, want", [
    (300, 44), (70000, 112), (-129, 127), (128, -128), (255, -1),
    (-300, -44), (16646144, 0)])
def test_wrap_is_the_int32_convert(value, want):
    a = np.int32(value)
    assert int(np.asarray(jnp.asarray(a).astype(jnp.int8))) == want
    assert int(kp.wrap_int8(torch.tensor([value], dtype=torch.int32))[0]) \
        == want
    assert int(kp.wrap_int8(torch.tensor([float(value)]))[0]) == want


def test_fixed_quantisation_multiplies_by_twenty():
    """The probe multiplies by the f32 constant 1 / 0.05 = 20.0; a true
    division by f32(0.05), as K2 divides, rounds otherwise on some
    inputs."""
    assert kp.FIXED_SCALE == probe.FIXED_SCALE
    assert kp.INV_FIXED_SCALE == 1.0 / probe.FIXED_SCALE == 20.0
    k = np.arange(0, 127, dtype=np.float64)
    h = np.float32((k + 0.5) * np.float64(np.float32(0.05)))
    h = np.concatenate([h, np.nextafter(h, np.float32(0)),
                        np.nextafter(h, np.float32(10))])
    jax_q = np.asarray(jnp.clip(jnp.round(jnp.asarray(h)
                                          * (1.0 / probe.FIXED_SCALE)),
                                -127, 127)).astype(np.int8)
    port_q = kp.quantize_fixed(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(port_q, jax_q)
    divided = pq.quantize_activation(
        torch.from_numpy(h), torch.tensor(np.float32(0.05))).numpy()
    assert (divided.astype(np.int8) != port_q).any()


def test_mxu_from_its_first_activation_is_the_chain(variables):
    _, tp = variables
    x = torch.from_numpy(rows(64, 10))
    acts = []
    out = kp.mxu_chain_ref(tp, x, acts)
    again = []
    np.testing.assert_array_equal(
        kp.mxu_hidden_ref(tp, acts[0], again).numpy(), out.numpy())
    assert all(torch.equal(a, b) for a, b in zip(acts, again))


@pytest.mark.parametrize("variant", kp.VARIANTS)
def test_probe_forward_refuses_cpu_tensors(variables, variant):
    _, tp = variables
    before = (dict(kp.LAUNCHES), pq.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        kp.probe_forward(tp, torch.zeros((4, 32)), variant)
    assert (kp.LAUNCHES, pq.LAUNCHES) == before


def test_probe_forward_refuses_an_unknown_variant(variables):
    with pytest.raises(ValueError, match="variant"):
        kp.probe_forward(variables[1], torch.zeros((4, 32)), "static")


def test_c_entry_arguments_match_the_ctypes_signature():
    """ctypes does not check: the wrapper's argument types must follow the
    C entry's parameters one for one."""
    with open(os.path.join(ROOT, "bilinear_tpu_torch", "csrc",
                           "int8_scale_probe.cu")) as f:
        src = f.read()
    sig = re.search(r'extern "C" int int8_scale_probe_forward\((.*?)\)',
                    src, re.S).group(1)
    kinds = [p.split()[0] if "*" not in p else "ptr"
             for p in (q.strip() for q in sig.split(","))]
    want = {"ptr": "c_void_p", "float": "c_float", "int": "c_int"}
    assert [want[k] for k in kinds] == [t.__name__ for t in kp._ARGTYPES]


def test_probe_script_refuses_to_run_without_a_card():
    """scripts/torch_int8_scale_probe.py times the card's kernels: on a
    machine without one it stops before any row."""
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", "torch_int8_scale_probe.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no CUDA device" in proc.stdout and "{" not in proc.stdout


# ---- K5's one launch: the plan and the weight stream ------------------------

PLAN_ROWS = (1, 63, 64, 65, 255, 4096, 65536)


@pytest.mark.parametrize("capacity", [kp.SMS // kp.CLUSTER, 30, 1])
@pytest.mark.parametrize("n", PLAN_ROWS)
def test_plan_covers_every_row_once(n, capacity):
    plan = kp.plan_probe(n, capacity)
    seen = np.zeros(n, np.int32)
    for block in range(plan.grid):
        for lo, hi in plan.rows_of(block, n):
            assert 0 < hi - lo <= plan.block_rows == 64
            seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n", PLAN_ROWS)
def test_plan_fits_one_block_per_sm(n):
    plan = kp.plan_probe(n)
    assert plan.smem_bytes == 1024 + 2 * 64 * 1024 + 6 * 16384 + 112
    assert plan.smem_bytes <= kp.SMEM_LIMIT == 232448
    assert plan.grid <= kp.SMS and plan.grid % plan.cluster == 0
    assert plan.cluster == 2 and plan.threads == 384
    assert plan.clusters == min(kp.SMS // 2, -(-n // 128))


def test_plan_refuses_no_rows():
    with pytest.raises(ValueError):
        kp.plan_probe(0)


def test_plan_constants_are_the_kernels():
    """ops/int8_scale_probe.py's plan and csrc/int8_scale_probe.cu's
    constants must agree: the wrapper sizes the grid and the skip scratch,
    the kernel walks the tiles."""
    with open(os.path.join(ROOT, "bilinear_tpu_torch", "csrc",
                           "int8_scale_probe.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("CL") == kp.CLUSTER
    assert const("BM") == kp.BLOCK_ROWS
    assert const("BN") == kp.STAGE_COLS
    assert const("SLAB") == kp.SLAB
    assert const("STAGES") == kp.STAGES
    assert const("THREADS") == kp.THREADS


def _image_offsets():
    """Where each weight byte lies in K5's stream, by a plain index map:
    {part: (offsets, (rows, K bytes))} for the encode, hidden layers 0-3 and
    the decode, each over all rows and K bytes of the weight's K-contiguous
    copy, and the encode's zero padding. Stages of 128 output columns x 128
    bytes of K; a decode stage: 2 slabs of 48 rows x 128 bytes."""
    stage, dec_sub = 128 * 128, 48 * 128
    dec_stage = 2 * dec_sub

    def in_stage(row, kb):
        return row * 128 + ((kb // 16) ^ (row % 8)) * 16 + kb % 16

    o, k = np.meshgrid(np.arange(1024), np.arange(64), indexing="ij")
    out = {"encode": ((o // 128) * stage + in_stage(o % 128, k), (1024, 64)),
           "pad": ((o // 128) * stage + in_stage(o % 128, k + 64), None)}
    o, k = np.meshgrid(np.arange(1024), np.arange(1024), indexing="ij")
    for layer in range(4):
        p, s = o // 128, k // 128
        base = 8 * stage + layer * 64 * stage + p * 8 * stage + s * stage
        if layer == 3:
            base = base + p * dec_stage
        out[f"hidden{layer}"] = (base + in_stage(o % 128, k % 128),
                                 (1024, 1024))
    o, k = np.meshgrid(np.arange(48), np.arange(2048), indexing="ij")
    p, d = k // 256, (k % 256) // 128
    base = 8 * stage + 3 * 64 * stage + (p + 1) * 8 * stage + p * dec_stage
    out["decode"] = (base + d * dec_sub + in_stage(o, k % 128), (48, 2048))
    return out


def test_weight_image_is_the_index_map(variables):
    _, tp = variables
    image = kp.weight_image(tp).numpy()
    assert image.dtype == np.uint8 and image.shape == (kp.IMAGE_BYTES,)
    enc, *hidden, dec = (t.contiguous().view(torch.uint8).numpy()
                         for t in tp["kmajor"])
    want = {"encode": enc, "decode": dec,
            **{f"hidden{i}": h for i, h in enumerate(hidden)}}
    covered = np.zeros(kp.IMAGE_BYTES, np.int32)
    for part, (offsets, shape) in _image_offsets().items():
        covered[offsets.ravel()] += 1
        if part == "pad":
            assert (image[offsets] == 0).all()
            continue
        assert want[part].shape == shape
        np.testing.assert_array_equal(image[offsets], want[part], err_msg=part)
    assert (covered == 1).all()  # every byte of the stream is one weight's


def test_weight_image_is_kept_while_the_weights_are(variables):
    _, tp = variables
    prepared = pq.PreparedInt8(tp)
    first = kp._image(prepared)
    assert kp._image(prepared) is first
    prepared["kmajor"] = [t.clone() for t in prepared["kmajor"]]
    again = kp._image(prepared)
    assert again is not first and torch.equal(again, first)


def test_swizzle_rows_moves_chunk_j_of_row_r_to_j_xor_r():
    rows = torch.arange(16 * 128, dtype=torch.int32).reshape(16, 128)
    out = kp.swizzle_rows(rows)
    for r in range(16):
        for j in range(8):
            np.testing.assert_array_equal(
                out[r, ((j ^ (r % 8)) * 16):((j ^ (r % 8)) * 16 + 16)],
                rows[r, j * 16:j * 16 + 16])


def test_fixed_rounding_without_conversions_is_rint():
    """csrc/lifting_common.cuh::quantize_mul rounds clip(rint(v * r), -127,
    127) for v >= 0 by adding 1.5 * 2^23 (after clamping to 128) and reading
    the integer off the float's bits: the same int8 as the plain version's
    round-half-to-even on every such input, ties and infinity included."""
    rs = np.random.RandomState(0)
    v = np.concatenate([
        rs.uniform(0, 10, 1_000_000), rs.uniform(0, 1e6, 10_000),
        (np.arange(0, 140) + 0.5) / 20, np.arange(0, 140) / 20,
        [0.0, np.inf, np.finfo(np.float32).max]]).astype(np.float32)
    with np.errstate(over="ignore"):
        v = np.concatenate([v, np.nextafter(v, np.float32(0)),
                            np.nextafter(v, np.float32(np.inf))])
        x = (v * np.float32(kp.INV_FIXED_SCALE)).astype(np.float32)
    want = kp.quantize_fixed(torch.from_numpy(v)).numpy().astype(np.int32)
    t = (np.minimum(x, np.float32(128)) + np.float32(12582912.0))
    got = np.minimum(t.astype(np.float32).view(np.int32) - 0x4B400000, 127)
    np.testing.assert_array_equal(got, want)


def test_sweep_script_builds_what_the_source_holds():
    """scripts/torch_k5_sweep.py rewrites the kernel's constants and, for
    its clock build, named call sites: each must still be in the source."""
    spec = importlib.util.spec_from_file_location(
        "torch_k5_sweep", os.path.join(ROOT, "scripts", "torch_k5_sweep.py"))
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    with open(os.path.join(ROOT, "bilinear_tpu_torch", "csrc",
                           "int8_scale_probe.cu")) as f:
        src = f.read()
    out = sweep.variant_source(src, 4, 5, clocks=True)
    assert "constexpr int CL = 4;" in out and "constexpr int STAGES = 5;" in out
    assert out.count("clock64()") >= 2 * (len(sweep.CLOCK_SITES) - 3)
    assert "k5_clocks_read" in out


def test_sweep_script_refuses_to_run_without_a_card():
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", "torch_k5_sweep.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no CUDA device" in proc.stdout and "{" not in proc.stdout
