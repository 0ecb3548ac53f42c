"""Spatial sharding on the card: K6's two stage entries against the
one-launch K6 and their plain versions; a small fused and int8 torch7
detector sharded over ``["cuda:0"] * S`` against its unsharded forward,
with the kernels' launches counted; and the full-width torch7 detector
over distinct cards (two or more), with the weights copied to them
counted. Needs NVIDIA cards and nvcc, so every test here carries the
``cuda`` marker and skips without them; the file imports no JAX. On one
card: ``python -m pytest tests/test_torch_port_spatial_cuda.py -m cuda
--noconftest -q -s`` (the suite's conftest.py imports JAX, which the
card's machine lacks); the distinct-cards test needs a machine with two
cards or more.

Tolerances: none. K6's stages put back together are the one launch's
bits, and every sharded forward is its unsharded forward's bits: the
kernels on haloed slabs are (chip_smoke.py phase 17a), and the float ops
between them are pointwise or per row.
"""
import time

import pytest
import torch

from bilinear_tpu_torch.device import disable_tf32
from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
from bilinear_tpu_torch.ops import _build, int8
from bilinear_tpu_torch.ops import resmodule as rk
from bilinear_tpu_torch.parallel import spatial
from bilinear_tpu_torch.parallel.mesh import shard_spatial

FULL_PER_FORWARD = 3 + 8 * 13  # ResModules of the full-width MainModel

pytestmark = pytest.mark.cuda

SIZE = dict(n_stacks=2, features=128, depth=2)
PER_FORWARD = 3 + 2 * 7  # ResModules of the model


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _build.build_all(["resmodule", "int8_conv"])
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(8, 64, 64, 128), (8, 16, 16, 256),
                                   (1, 4, 4, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k6_stages_are_the_one_launch(card, shape, dtype):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=gen) * (torch.rand(
        shape[0], 1, 1, 1, generator=gen) * 3 + 0.1)).to(dtype).to(card)
    want_q, want_s = int8.quantize_activations(x)
    for s in (2, 4):
        parts = shard_spatial(["cuda:0"] * s, x, axis=1, unit=1)
        before = int8.LAUNCHES_QUANTIZE_STAGES
        amax = [int8.activation_amax(t) for t in parts]
        scale = int8.slab_scale(amax)
        got = torch.cat([int8.quantize_scaled(t, scale) for t in parts], 1)
        assert int8.LAUNCHES_QUANTIZE_STAGES - before == 2 * s
        assert torch.equal(scale, want_s.reshape(-1))
        assert torch.equal(got, want_q)
        for a, t in zip(amax, parts):
            assert torch.equal(a, int8.activation_amax_ref(t))
            assert torch.equal(int8.quantize_scaled(t, scale),
                               int8.quantize_scaled_ref(t, scale))


@pytest.mark.parametrize("knobs", [dict(fused=True), dict(quantize="int8")],
                         ids=["fused", "int8"])
def test_small_detector_sharded_on_the_card(card, knobs):
    model = MainModel(**SIZE, dtype=torch.bfloat16, **knobs,
                      generator=torch.Generator().manual_seed(1))
    model = model.to(card).eval()
    images = torch.rand((2, 64, 64, 3), generator=torch.Generator()
                        .manual_seed(2)).to(card)
    with torch.no_grad():
        want = model(images).float()
    for s in (2, 4):
        rk.LAUNCHES_FWD_EVAL = int8.LAUNCHES_CONV = 0
        int8.LAUNCHES_QUANTIZE = int8.LAUNCHES_QUANTIZE_STAGES = 0
        got = spatial.spatial_forward(model, images, ["cuda:0"] * s)
        torch.cuda.synchronize()
        if "fused" in knobs:
            assert rk.LAUNCHES_FWD_EVAL == PER_FORWARD * s
        else:
            assert int8.LAUNCHES_CONV == 3 * PER_FORWARD * s
            assert int8.LAUNCHES_QUANTIZE_STAGES == 6 * PER_FORWARD * s
            assert int8.LAUNCHES_QUANTIZE == rk.LAUNCHES_FWD_EVAL == 0
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two NVIDIA cards or more")
    _build.build_all(["resmodule", "int8_conv"])
    # Full f32, as every CLI runs: with cuDNN's TF32 (torch's default) the
    # f32 forward over 4 cards left the unsharded bits by 2.4e-2.
    disable_tf32()
    return n


@pytest.mark.parametrize("knobs", [
    {}, dict(fused=True, dtype=torch.bfloat16),
    dict(quantize="int8", dtype=torch.bfloat16)],
    ids=["f32", "fused_bf16", "int8"])
def test_full_width_over_distinct_cards(cards, knobs):
    """The full-width torch7 detector on a 256x256 frame over 2 (and 4)
    distinct cards: the unsharded forward's bits, the kernels launched on
    every slab, the weights copied to each other card once at set-up, and
    after the first forward (which copies the prepared int8 kernels) only
    what is no stored weight, such as a weight cast to bf16."""
    model = MainModel(**knobs, generator=torch.Generator().manual_seed(3))
    model = model.to("cuda:0").eval()
    images = torch.rand((1, 256, 256, 3), generator=torch.Generator()
                        .manual_seed(4)).to("cuda:0")
    with torch.no_grad():
        want = model(images)
    weights = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
               for t in list(model.parameters()) + list(model.buffers())}
    for n in sorted({2, min(cards, 4)}):
        devices = [f"cuda:{i}" for i in range(n)]
        before = spatial.COPIED_BYTES
        fn = spatial.make_spatial_fn(model, devices)
        setup = spatial.COPIED_BYTES - before
        copied, ms, equal, launches = [], [], [], []
        for _ in range(2):
            rk.LAUNCHES_FWD_EVAL = int8.LAUNCHES_CONV = 0
            before = spatial.COPIED_BYTES
            start = time.perf_counter()
            got = fn(images)
            for d in devices:
                torch.cuda.synchronize(d)
            ms.append((time.perf_counter() - start) * 1e3)
            copied.append(spatial.COPIED_BYTES - before)
            equal.append(bool(torch.equal(got, want)))
            launches.append((rk.LAUNCHES_FWD_EVAL, int8.LAUNCHES_CONV))
        print(f"torch7 {'_'.join(map(str, knobs.values())) or 'f32'} over "
              f"{n} cards ({torch.cuda.get_device_name(0)}): weights copied "
              f"at set-up {setup} B, by the first and second forwards "
              f"{copied} B, {ms[0]:.1f} / {ms[1]:.1f} ms by the host clock; "
              f"bit-equal {equal}, max|d| "
              f"{float((got - want).abs().max()):.3e}; launches (K3, K7) "
              f"{launches}")
        assert equal == [True, True]
        assert setup == (n - 1) * sum(weights.values())
        if knobs.get("fused"):
            assert launches == [(FULL_PER_FORWARD * n, 0)] * 2
        if knobs.get("quantize"):
            assert launches == [(0, 3 * FULL_PER_FORWARD * n)] * 2
        assert copied[1] <= copied[0]
        if not knobs:
            assert copied == [0, 0]
