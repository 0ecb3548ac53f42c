"""The port's int8 convolutions of the detectors' eval path
(bilinear_tpu_torch/ops/int8.py, ``quantize="int8"`` of both detectors,
End2End and End2EndServer, ``serve --quantize``) against the JAX package's
(bilinear_tpu/ops/int8.py and the models' ``quantize="int8"``) on the CPU,
where the port runs the plain versions of kernels K6 and K7. Inputs are
made with numpy from a seed and handed to both packages.

Tolerances, each measured before it was set:
- ``quantize_conv_kernel``, ``quantize_activations``: bit-equal (the same
  true divisions in the same order).
- ``int8_conv_ref``: the int32 accumulators equal; the outputs within 1 ulp
  of JAX's (measured: bit-equal, f32 and bf16).
- The small models (2 stacks, 16 features, depth 2, 64-pixel inputs) with
  ``quantize="int8"``, held to JAX's int8 model against the size of the
  quantization itself (JAX's int8 heatmaps minus the float ones, which
  the port's float model gives to 5e-7 of max|ref|): the port's mean gap
  at most 0.25x that error's mean (measured 0.024x torch7, 0.15x preact),
  its largest at most 0.5x that error's largest (0.17x, 0.29x). The
  quantized activations are JAX's bit for bit on equal inputs, but the
  float parts between the convs (BN, the skip path) differ in the last
  ulps; a value at a rounding boundary of the int8 grid then moves one
  step (1/127 of its sample's amax) and carries (12-15% of the heatmaps
  stay bit-equal).
- End2EndServer(quantize="int8"): the soft-argmax of nearly flat heatmaps
  turns those steps into pixels, so the port's pose2d and mm are held to
  JAX's int8 answers at half the quantization's own mean movement
  (measured 0.28x and 0.39x).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bilinear_tpu.models.hourglass import StackedHourglass as JaxPreact
from bilinear_tpu.models.hourglass_torch7 import MainModel as JaxTorch7
from bilinear_tpu.ops import int8 as jint8
from bilinear_tpu.serving import End2EndServer as JaxEnd2EndServer
from bilinear_tpu_torch.cli import serve as pserve
from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
from bilinear_tpu_torch.io.checkpoint import save_checkpoint
from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.models.hourglass import StackedHourglass
from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
from bilinear_tpu_torch.ops import int8
from bilinear_tpu_torch.serving import End2EndServer
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread, scramble_bn, ulp_gap

SIZE = dict(n_stacks=2, features=16, depth=2)
JT7 = dict(n_stacks=2, features=16, depth=2)
JPRE = dict(stacks=2, out_channels=16, compression_time=2)


def _x(shape, seed):
    """Activations whose samples differ in range (per-sample scales)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape) * rs.uniform(0.1, 4.0, (shape[0], 1, 1, 1))
    return x.astype(np.float32)


def _kernel(k, ci, co, seed):
    rs = np.random.RandomState(seed)
    w = rs.randn(k, k, ci, co) * rs.uniform(0.01, 0.2, (1, 1, 1, co))
    return w.astype(np.float32), rs.randn(co).astype(np.float32)


@pytest.mark.parametrize("k,ci,co", [(1, 64, 16), (3, 64, 64),
                                     (3, 128, 128)])
def test_quantization_is_jax_bit_for_bit(k, ci, co):
    w, _ = _kernel(k, ci, co, 0)
    kq, ks = int8.quantize_conv_kernel(torch.from_numpy(w))
    jkq, jks = jint8.quantize_conv_kernel(jnp.asarray(w))
    assert kq.dtype == torch.int8 and kq.shape == (k, k, ci, co)
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    prepared = int8.prepare_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(prepared.kq.permute(1, 2, 3, 0).numpy(),
                                  np.asarray(jkq))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        x = _x((3, 5, 7, ci), 1)
        xq, sx = int8.quantize_activations(torch.from_numpy(x).to(dt))
        jxq, jsx = jint8.quantize_activations(jnp.asarray(x, jdt))
        assert xq.dtype == torch.int8 and sx.shape == (3, 1, 1, 1)
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
        np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    # An all-zero sample takes the 1e-12 floor, not a division by zero.
    xq, sx = int8.quantize_activations(torch.zeros(1, 2, 2, 8))
    assert float(sx) == np.float32(1e-12) / np.float32(127)
    assert not xq.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("k,hw", [(1, (7, 5)), (3, (9, 7))])
def test_int8_conv_ref_matches_jax(k, hw, bias, dtype):
    """Odd spatial sizes (the padding's edges on both axes), 64 -> 64."""
    ci = co = 64
    w, b = _kernel(k, ci, co, 2)
    x = _x((2,) + hw + (ci,), 3)
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tb = torch.from_numpy(b) if bias else None
    prepared = int8.prepare_kernel(torch.from_numpy(w), tb)
    xq, sx = int8.quantize_activations_ref(torch.from_numpy(x).to(dt))
    acc = int8.int8_conv_acc_ref(xq, prepared.kq)
    jkq, _ = jint8.quantize_conv_kernel(jnp.asarray(w))
    jacc = lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jkq, (1, 1), [((k - 1) // 2,) * 2] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    got = int8.int8_conv(torch.from_numpy(x).to(dt), torch.from_numpy(w),
                         tb)
    ref = jint8.int8_conv(jnp.asarray(x, jdt), jnp.asarray(w),
                          jnp.asarray(b) if bias else None)
    assert got.dtype == dt and got.shape == (2,) + hw + (co,)
    g = got.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    same_sign = np.sign(g) == np.sign(r)
    assert same_sign[np.abs(r) > 0].all()
    step = 1 if dtype == "float32" else 1 << 16  # a bf16 ulp, in f32 bits
    assert ulp_gap(np.abs(g), np.abs(r)) <= step
    assert torch.equal(got, int8.int8_conv_ref(
        torch.from_numpy(x).to(dt), prepared=prepared))


def test_plain_accumulator_is_exact_where_f32_is_not():
    """K = 9 * 256 with every product 127 * 127: |acc| = 37,161,216 > 2^24,
    which a float32 accumulation cannot hold exactly but the plain version
    does; torch's CPU conv of int8 would wrap."""
    xq = torch.full((1, 3, 3, 256), 127, dtype=torch.int8)
    kq = torch.full((1, 3, 3, 256), 127, dtype=torch.int8)
    kq[0, 0, 0, 0] = -126
    acc = int8.int8_conv_acc_ref(xq, kq)
    want = 9 * 256 * 127 * 127 - 127 * 127 - 126 * 127
    assert int(acc[0, 1, 1, 0]) == want
    assert int(np.float32(want)) != want  # beyond f32's exact integers


def test_cuda_wrappers_refuse_cpu_tensors():
    prepared = int8.prepare_kernel(torch.ones(1, 1, 64, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8.int8_conv_cuda(torch.zeros(1, 2, 2, 64, dtype=torch.int8),
                            torch.ones(1), prepared, torch.float32)


# ------------------------------------------------------------ models


def _jax_tree(model, to_jax, seed):
    params, stats = to_jax(model.state_dict())
    scramble = scramble_bn(np.random.RandomState(seed))
    return (jax.tree_util.tree_map_with_path(scramble, params),
            jax.tree_util.tree_map_with_path(scramble, stats))


VARIANTS = {
    "torch7": (MainModel, wt.hourglass_torch7_to_jax,
               wt.hourglass_torch7_from_jax, lambda q: JaxTorch7(
                   quantize=q, **JT7)),
    "preact": (StackedHourglass, wt.hourglass_preact_to_jax,
               wt.hourglass_preact_from_jax, lambda q: JaxPreact(
                   quantize=q, **JPRE)),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    """The port's model (float and int8) and the JAX trees, from one
    seeded port initialisation with scrambled BN."""
    cls, to_jax, from_jax, jax_model = VARIANTS[request.param]
    params, stats = _jax_tree(
        cls(**SIZE, generator=torch.Generator().manual_seed(0)), to_jax, 0)
    ports = {}
    for q in (None, "int8"):
        m = cls(**SIZE, quantize=q)
        m.load_state_dict(from_jax(params, stats))
        ports[q] = m
    return request.param, ports, jax_model, params, stats


def test_eval_forward_int8_matches_jax(models):
    """The int8 eval forward against JAX's (gates in the module's
    docstring), and within JAX's int8-versus-float gates of the float model
    (tests/test_hourglass_int8.py): mean < 1%, max < 5% of the heatmaps'
    range."""
    name, ports, jax_model, params, stats = models
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: jax_model("int8").apply(
        v, x, train=False))({"params": params, "batch_stats": stats},
                            jnp.asarray(x)))
    with torch.no_grad():
        got = ports["int8"].eval()(torch.from_numpy(x)).numpy()
        flt = ports[None].eval()(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 2, 16, 16, 16)
    gap, err = np.abs(got - ref), np.abs(ref - flt)
    assert gap.mean() <= 0.25 * err.mean(), (name, gap.mean() / err.mean())
    assert gap.max() <= 0.5 * err.max(), (name, gap.max() / err.max())
    rng = flt.max() - flt.min()
    assert np.abs(got - flt).mean() < 0.01 * rng
    assert np.abs(got - flt).max() < 0.05 * rng


def test_train_mode_and_state_dict_ignore_quantize(models):
    """Train mode is the float model's bit for bit (outputs and the BN
    statistics it updates), and the state_dict is the same keys and
    tensors before and after an int8 forward."""
    name, ports, _, _, _ = models
    before = {k: v.clone() for k, v in ports["int8"].state_dict().items()}
    assert before.keys() == ports[None].state_dict().keys()
    with torch.no_grad():
        ports["int8"].eval()(torch.zeros(1, 64, 64, 3))
    after = ports["int8"].state_dict()
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], before[k]) for k in before)
    x = torch.from_numpy(
        np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32))
    a, b = ports["int8"].train(), ports[None].train()
    assert torch.equal(a(x), b(x))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_fused_int8_model_bypasses_the_fused_blocks(monkeypatch):
    """A fused torch7 model in int8 eval mode never enters the K3 path
    (JAX: ``if self.fused and not use_int8``); in float eval it does."""
    from bilinear_tpu_torch.ops import resmodule as rk

    calls = []
    real = rk.res_block_eval
    monkeypatch.setattr(rk, "res_block_eval",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    x = torch.zeros(1, 32, 32, 3)
    with torch.no_grad():
        MainModel(**SIZE, fused=True, quantize="int8").eval()(x)
        assert not calls
        MainModel(**SIZE, fused=True).eval()(x)
    assert calls
    with pytest.raises(ValueError, match="unsupported quantize"):
        MainModel(**SIZE, quantize="int4")
    with pytest.raises(ValueError, match="unsupported quantize"):
        StackedHourglass(**SIZE, quantize="int4")


def test_weights_quantized_once_and_again_after_a_reload():
    model = MainModel(**SIZE, quantize="int8").eval()
    conv = model.hgArray[0].res1[0].resSeq[5]
    x = torch.rand(1, 32, 32, 3)
    with torch.no_grad():
        model(x)
        first = conv.__dict__["_int8_prepared"][1]
        model(x)
        assert conv.__dict__["_int8_prepared"][1] is first
        sd = {k: v * 2 if k.endswith("resSeq.5.weight") else v
              for k, v in model.state_dict().items()}
        model.load_state_dict(sd)
        model(x)
    again = conv.__dict__["_int8_prepared"][1]
    assert again is not first
    assert torch.equal(again.kq, first.kq)  # doubling keeps the grid
    assert torch.equal(again.scale, first.scale * 2)


# ------------------------------------------------------------ serving


def _e2e_vars(seed=0):
    model = End2End(variant="torch7", **SIZE,
                    generator=torch.Generator().manual_seed(seed))
    params, stats = wt.end2end_to_jax(model.state_dict(), "torch7")
    scramble = scramble_bn(np.random.RandomState(seed))
    return {"params": jax.tree_util.tree_map_with_path(scramble, params),
            "batch_stats": jax.tree_util.tree_map_with_path(scramble,
                                                            stats)}


def test_end2end_server_int8_matches_jax():
    """End2EndServer(quantize="int8", device="cpu") against the JAX
    server's int8 answers, at most half as far from them (mean) as they are
    from the float answers (measured 0.28x pose2d, 0.39x mm); and against
    its own float answers within JAX's test_end2end_server_int8 gates."""
    rs = np.random.RandomState(0)
    stats = (rs.randn(32).astype(np.float32) * 50 + 300,
             np.full(32, 60.0, np.float32),
             np.zeros(48, np.float32), np.full(48, 100.0, np.float32))
    v = _e2e_vars()
    frames = rs.rand(3, 256, 256, 3).astype(np.float32)

    def port(quantize):
        return End2EndServer(v, *stats, dtype=torch.float32,
                             batch_sizes=(4,), model_kw=SIZE,
                             quantize=quantize, device="cpu")

    p2, mm = port("int8").predict(frames)
    p2_f, mm_f = port(None).predict(frames)
    jp2, jmm = (np.asarray(a) for a in JaxEnd2EndServer(
        v, *stats, dtype=jnp.float32, batch_sizes=(4,), model_kw=JT7,
        quantize="int8").predict(frames))
    assert p2.shape == (3, 16, 2) and mm.shape == (3, 16, 3)

    def dist(a, b):
        return np.linalg.norm(a - b, axis=-1).mean()

    assert dist(p2, jp2) <= 0.5 * dist(jp2, p2_f)
    assert np.abs(mm - jmm).mean() <= 0.5 * np.abs(jmm - mm_f).mean()
    assert dist(p2, p2_f) < 2.0
    assert np.abs(mm - mm_f).mean() < 0.1 * (np.abs(mm_f).mean() + 1e-9)
    with pytest.raises(ValueError, match="unsupported quantize"):
        port("int8-static")


def test_serve_cli_maps_int8_static_to_int8_for_end2end(tmp_path):
    """serve --kind end2end --quantize int8 and int8-static both build an
    int8 End2EndServer (the static scales are the lifting MLP's, JAX
    cli/serve.py:85), whose model carries the int8 convs."""
    d = write_h36m_dataset(str(tmp_path / "Human3.6M"), n_train=8,
                           n_valid=4)
    run = str(tmp_path / "End2End")
    v = _e2e_vars(1)
    save_checkpoint(os.path.join(run, "parameter"), 1, v["params"],
                    v["batch_stats"])
    for quantize in ("int8", "int8-static"):
        args = pserve.build_parser().parse_args(
            ["--kind", "end2end", "--quantize", quantize, "--run-dir", run,
             "--data-dir", d, "--device", "cpu", "--port", "0",
             "--n-stacks", "2", "--features", "16", "--depth", "2",
             "--batch-sizes", "1"])
        http = pserve.build_server(args)
        http.start()
        try:
            assert http.end2end.quantize == "int8"
            res = http.end2end._model.hourglass.hgArray[0].res1[0]
            assert res.quantize == "int8" and res.fused
            p2, mm = http.end2end.predict(np.zeros((1, 256, 256, 3),
                                                   np.uint8))
            assert np.isfinite(p2).all() and np.isfinite(mm).all()
        finally:
            http.stop()
