"""Port kernel K2's plain version (bilinear_tpu_torch/ops/lifting_int8.py)
vs the JAX package's int8 path (``backend="xla"``, the oracle its own tests
hold the Pallas kernel to bit for bit).

Element-wise equality is not the contract across frameworks: the bf16
encode sums in another order, so an activation that sits at a
quantization boundary rounds one int8 step apart now and then (measured
~21% of outputs bit-equal, mean |diff| ~3e-4, max ~0.19 at random init).
The gates are the mean |diff|, the 99th percentile, and the accuracy gate
of tests/test_lifting_int8.py on a briefly trained net."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.ops.pallas import lifting as jl
from bilinear_tpu.ops.pallas import lifting_int8 as jq
from bilinear_tpu.train.bilinear import BilinearTrainer
from bilinear_tpu_torch.ops import lifting as pl
from bilinear_tpu_torch.ops import lifting_int8 as pq
from torch_port_fixtures import (one_torch_thread, rows,
                                 scrambled_variables, ulp_gap)


def _gate(out, ref, scale):
    d = np.abs(np.asarray(out) - np.asarray(ref))
    assert np.isfinite(out).all()
    assert d.mean() < 2e-3 * scale, d.mean()
    assert np.percentile(d, 99) < 2e-2 * scale, np.percentile(d, 99)


@pytest.fixture(scope="module")
def variables():
    params, stats = scrambled_variables(0)
    return params, stats, jq.prepare_weights_int8(params, stats), \
        pq.prepare_weights_int8(params, stats, device="cpu")


def test_quantize_weight_matches_jax():
    w = np.random.RandomState(0).randn(1024, 1024).astype(np.float32)
    jwq, jws = jq.quantize_weight(jnp.asarray(w))
    wq, ws = pq.quantize_weight(torch.from_numpy(w))
    assert wq.dtype == torch.int8
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    assert ulp_gap(ws.numpy(), jws) <= 1


def test_prepare_weights_int8_matches_jax(variables):
    """wq exactly equal. The scales differ by up to 2 ulp (measured): the
    BN fold ``scale / sqrt(var + eps)``, the folded kernel and its amax /
    127 each round in f32, and each framework lands within 1 ulp of the
    exact value on its own side of it."""
    _, _, jp, tp = variables
    for (jwq, jws, jb), (wq, ws, b) in zip(jp["hidden"], tp["hidden"]):
        np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
        assert ulp_gap(ws.numpy(), jws) <= 2
        assert ulp_gap(b.numpy(), jb) <= 4
        assert int(wq.abs().max()) == 127
    assert tp["encode"][0].dtype == torch.bfloat16
    assert tp["decode"][0].dtype == torch.bfloat16


def test_calibrate_scales_matches_jax(variables):
    _, _, jp, tp = variables
    x = rows(1024, 5)
    js = jq.calibrate_scales(jp, jnp.asarray(x))
    ps = pq.calibrate_scales(tp, x)
    assert all(isinstance(s, float) for s in ps) and len(ps) == 4
    for a, b in zip(js, ps):
        # same floats, or one unit apart in the 3rd significant digit
        assert abs(a - b) <= 1.01 * 10 ** (np.floor(np.log10(a)) - 2)
    assert pq._round_sig(0.012345) == jq._round_sig(0.012345) == 0.0123


@pytest.mark.parametrize("n", [512, 100, 700])
def test_dynamic_matches_jax(variables, n):
    """n = 100 and 700 pad the last 512-row group with zero rows, which
    enter that group's amax as in the JAX path."""
    _, _, jp, tp = variables
    x = rows(n, n)
    ref = np.asarray(jq.lifting_forward_int8(x=jnp.asarray(x), prepared=jp,
                                             backend="xla"))
    out = pq.lifting_forward_int8(x=torch.from_numpy(x), prepared=tp).numpy()
    assert out.shape == (n, 48)
    _gate(out, ref, np.abs(ref).mean())


def test_padding_rows_enter_last_group_amax(variables):
    """With a large encode bias the zero padding rows (relu(enc_b) after
    encode) hold the last group's amax: the port must match JAX there, and
    the result must differ from an unpadded group."""
    params, stats, _, _ = variables
    params = jax.tree.map(np.copy, params)
    # Channel 0: bias 30, weights +1 against all-negative inputs, so real
    # rows sit far below the padding row's relu(30).
    params["encode"]["linear"]["bias"][0] = 30.0
    params["encode"]["linear"]["kernel"][:, 0] = 1.0
    jp = jq.prepare_weights_int8(params, stats)
    tp = pq.prepare_weights_int8(params, stats, device="cpu")
    x = -np.abs(rows(100, 6))
    amaxes = []
    xp = pq._pad_rows(torch.from_numpy(x).to(torch.bfloat16), 512)
    pq.forward_chain(tp, (None,) * 4, xp[None], amaxes)
    unpadded = []
    pq.forward_chain(tp, (None,) * 4, xp[None, :100], unpadded)
    assert float(amaxes[0][0]) > float(unpadded[0][0])  # padding holds the max
    ref = np.asarray(jq.lifting_forward_int8(x=jnp.asarray(x), prepared=jp,
                                             backend="xla"))
    out = pq.lifting_forward_int8(x=torch.from_numpy(x), prepared=tp).numpy()
    _gate(out, ref, np.abs(ref).mean())
    no_pad = pq.forward_chain(tp, (None,) * 4, xp[None, :100])[0].numpy()
    assert np.abs(no_pad - ref).mean() > np.abs(out - ref).mean()


def test_static_matches_jax(variables):
    _, _, jp, tp = variables
    x = rows(1024, 7)
    scales = jq.calibrate_scales(jp, jnp.asarray(x))
    ref = np.asarray(jq.lifting_forward_int8(
        x=jnp.asarray(x), prepared=jp, backend="xla", static_scales=scales))
    out = pq.lifting_forward_int8(x=torch.from_numpy(x), prepared=tp,
                                  static_scales=scales).numpy()
    _gate(out, ref, np.abs(ref).mean())


def test_static_numerics_are_tile_independent(variables):
    _, _, _, tp = variables
    x = torch.from_numpy(rows(2048, 3))
    scales = pq.calibrate_scales(tp, x)
    y512 = pq.lifting_forward_int8_ref(tp, x, scales, tile=512)
    y1024 = pq.lifting_forward_int8_ref(tp, x, scales, tile=1024)
    np.testing.assert_array_equal(y512.numpy(), y1024.numpy())


def test_kernel_wrapper_refuses_cpu_tensors(variables):
    _, _, _, tp = variables
    before = pq.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        pq._launch(tp, torch.zeros((4, 32), dtype=torch.bfloat16),
                   (None,) * 4, pq.GROUP)
    assert pq.LAUNCHES == before


# ---- the accuracy gate of tests/test_lifting_int8.py on a trained net ----


def _manifold(n, seed, basis):
    z = np.random.RandomState(seed).randn(n, 5).astype(np.float32)
    p3 = z @ basis
    p2 = p3.reshape(n, 16, 3)[:, :, :2].reshape(n, 32)
    p2 = p2 + 0.01 * np.random.RandomState(seed + 1).randn(n, 32).astype(
        np.float32)
    return p2, p3


@pytest.fixture(scope="module")
def trained():
    basis = np.random.RandomState(0).randn(5, 48).astype(np.float32)
    x_tr, y_tr = _manifold(4096, 1, basis)
    mx, sx = x_tr.mean(0), x_tr.std(0) + 1e-8
    my, sy = y_tr.mean(0), y_tr.std(0) + 1e-8
    trainer = BilinearTrainer(batch_size=256)
    state = trainer.init_state(jax.random.PRNGKey(0))
    for e in range(3):
        state, _ = trainer.train_epoch(
            state, jnp.asarray((x_tr - mx) / sx), jnp.asarray((y_tr - my) / sy),
            jax.random.PRNGKey(e),
        )
    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    x_va, y_va = _manifold(512, 99, basis)
    return params, stats, (mx, sx, my, sy), (x_va, y_va)


@pytest.mark.parametrize("static", [False, True])
def test_trained_accuracy_within_gates(trained, static):
    """int8 moves the metric by < 0.5% against the f32 forward, and
    agrees with the JAX int8 path on the same trained weights."""
    params, stats, (mx, sx, my, sy), (x_va, y_va) = trained
    xn = ((x_va - mx) / sx).astype(np.float32)
    ref = pl.lifting_forward(params, stats, torch.from_numpy(xn),
                             dtype=torch.float32).numpy()
    tp = pq.prepare_weights_int8(params, stats, device="cpu")
    scales = pq.calibrate_scales(tp, xn) if static else None
    out = pq.lifting_forward_int8(x=torch.from_numpy(xn), prepared=tp,
                                  static_scales=scales).numpy()
    p_ref = (ref * sy + my).reshape(-1, 16, 3)
    p_q = (out * sy + my).reshape(-1, 16, 3)
    gt = y_va.reshape(-1, 16, 3)
    mpjpe_ref = np.linalg.norm(p_ref - gt, axis=-1).mean()
    mpjpe_q = np.linalg.norm(p_q - gt, axis=-1).mean()
    delta = np.linalg.norm(p_ref - p_q, axis=-1).mean()
    assert delta < 0.10 * mpjpe_ref
    assert abs(mpjpe_q - mpjpe_ref) < 0.005 * mpjpe_ref

    jp = jq.prepare_weights_int8(params, stats)
    jout = np.asarray(jq.lifting_forward_int8(
        x=jnp.asarray(xn), prepared=jp, backend="xla",
        static_scales=scales))
    p_j = (jout * sy + my).reshape(-1, 16, 3)
    mpjpe_j = np.linalg.norm(p_j - gt, axis=-1).mean()
    assert abs(mpjpe_q - mpjpe_j) < 0.005 * mpjpe_ref
    _gate(out, jout, np.abs(jout).mean())
    # The JAX f32 kernel agrees with the port's f32 plain path too.
    jref = np.asarray(jl.lifting_forward(params, stats, jnp.asarray(xn),
                                         dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(ref, jref, rtol=2e-3, atol=2e-3)


# ---- the kernel's prepared form, scratch and producer-side quantisation ----


def test_kmajor_copies_are_exact_transposes(variables):
    """int8 wgmma reads both operands K-contiguous: every weight has an
    (out, in) copy for the kernel, and wq stays (in, out) for the plain
    version (and bit-equal to JAX, test_prepare_weights_int8_matches_jax)."""
    _, _, _, tp = variables
    weights = [tp["encode"][0], *(h[0] for h in tp["hidden"]),
               tp["decode"][0]]
    assert len(tp["kmajor"]) == 6
    for w, wt in zip(weights, tp["kmajor"]):
        assert wt.is_contiguous() and wt.dtype == w.dtype
        assert wt.shape == (w.shape[1], w.shape[0])
        assert torch.equal(wt, w.t())
    assert [w.dtype for w in tp["kmajor"]] == [torch.bfloat16] \
        + [torch.int8] * 4 + [torch.bfloat16]


@pytest.mark.parametrize("quantize", ["int8", "int8-static"])
def test_reload_rebuilds_kmajor_copies(variables, tmp_path, quantize):
    from bilinear_tpu_torch.io.checkpoint import save_checkpoint
    from bilinear_tpu_torch.serving import LiftingServer

    params, stats, _, _ = variables
    one, zero = np.ones(32, np.float32), np.zeros(32, np.float32)
    server = LiftingServer(params, stats, zero, one, np.zeros(48, np.float32),
                           np.ones(48, np.float32), device="cpu",
                           quantize=quantize)
    before = server._engine.prepared
    pdir = str(tmp_path / "parameter")
    save_checkpoint(pdir, 2, *scrambled_variables(1))
    server.parameter_dir, server.epoch = pdir, 1
    assert server.reload() is True
    after = server._engine.prepared
    assert not torch.equal(after["hidden"][0][0], before["hidden"][0][0])
    for (wq, _, _), wt in zip(after["hidden"], after["kmajor"][1:5]):
        assert torch.equal(wt, wq.t())
    assert torch.equal(after["kmajor"][0], after["encode"][0].t())
    assert torch.equal(after["kmajor"][5], after["decode"][0].t())


def _static_chain_quantised_at_producer(tp, scales, x):
    """The static forward as the kernel runs it: every activation is
    quantised where it is PRODUCED, with the scale of the layer that will
    consume it, and travels as int8; f32 survives only as a skip."""
    enc_w, enc_b = tp["encode"]
    dec_w, dec_b = tp["decode"]
    h0 = torch.relu(x.to(torch.bfloat16).float() @ enc_w.float() + enc_b)
    q = pq.quantize_activation(h0, torch.tensor(scales[0]))
    skip, out = h0, None
    for l, (wq, ws, b) in enumerate(tp["hidden"]):
        s = torch.tensor(scales[l], dtype=torch.float32)
        y = torch.relu((q @ wq.float()) * (s * ws) + b)
        if l in (1, 3):
            y = y + skip
            skip = y
        if l < 3:
            q = pq.quantize_activation(y, torch.tensor(scales[l + 1]))
        else:
            out = y.to(torch.bfloat16).float() @ dec_w.float() + dec_b
    return out


@pytest.mark.parametrize("n", [100, 512, 1024])
def test_quantising_at_the_producer_is_bit_equal(variables, n):
    _, _, _, tp = variables
    x = torch.from_numpy(rows(n, 11))
    scales = pq.calibrate_scales(tp, rows(1024, 5))
    ref = pq.forward_chain(tp, scales, x[None])[0]
    out = _static_chain_quantised_at_producer(tp, scales, x)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


@pytest.mark.parametrize("n", [1, 512, 513, 65536])
def test_dynamic_scratch_sizing(n):
    """One amax and one tile counter per hidden layer and 512-row group of
    the rows the kernel sees: n, or n + 1 with the padding row."""
    m = n if n % pq.GROUP == 0 else n + 1
    groups, shape = pq.dynamic_scratch(m, pq.GROUP)
    assert groups == -(-n // pq.GROUP)  # the padding row opens no group
    assert shape == (2, 4, groups)
    assert pq.dynamic_scratch(4096, pq._ONE_GROUP) == (1, (2, 4, 1))
    assert pq.GROUP % 128 == 0  # a row tile never straddles two groups


def test_quantize_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        pq.quantize_rows_cuda(torch.zeros((4, 1024)), torch.ones(1), 512)


def test_launch_refuses_mixed_scales_and_bad_groups(variables):
    """Argument checks that need no card come before any launch."""
    _, _, _, tp = variables
    before = pq.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        pq._launch(tp, torch.zeros((4, 32), dtype=torch.bfloat16),
                   (0.1, None, 0.1, 0.1), pq.GROUP)
    assert pq.LAUNCHES == before


@pytest.mark.parametrize("m, launches", [
    (0, 0), (1, 2), (257, 2), (pl.FUSED_MAX_ROWS, 2),
    (pl.FUSED_MAX_ROWS + 1, 7), (65536, 7)])
def test_dynamic_launches_follow_the_path(m, launches):
    """A serving batch is the scratch's memset and one kernel; a bulk batch
    the memset and six GEMMs."""
    assert pq.dynamic_launches(m) == launches


@pytest.mark.parametrize("m, group_rows, capacity, want", [
    (1025, pq.GROUP, 4224, False), (65537, pq.GROUP, 4224, False),
    (4096, pq._ONE_GROUP, 4224, False), (4224, pq._ONE_GROUP, 4224, False),
    (4225, pq._ONE_GROUP, 4224, True), (8192, pq._ONE_GROUP, 4224, True),
    (8192, pq._ONE_GROUP, 8192, False), (2048, pq.GROUP, 256, True)])
def test_quantize_pass_only_for_a_group_the_card_cannot_hold(
        m, group_rows, capacity, want):
    """Served batches (512-row groups) quantise where they are produced; one
    group of more rows than the card holds tiles for runs the pass."""
    assert pq.needs_quantize_pass(m, group_rows, capacity) is want
    assert pq.dynamic_launches(m, want) == (11 if want else 7)


def test_prepared_form_holds_only_its_weights(variables):
    """The wrapper's note of what it validated is no entry of the prepared
    form, and a replaced tensor is validated again."""
    _, _, _, tp = variables
    dev = torch.device("cpu")
    first = pq._weight_pointers(tp, dev)
    assert set(tp) == {"encode", "hidden", "decode", "kmajor"}
    assert tp.checked is not None and pq._weight_pointers(tp, dev) == first
    wq, ws, b = tp["hidden"][1]
    old = tp["hidden"][1]
    try:
        tp["hidden"][1] = (wq, ws[:512].contiguous(), b)
        with pytest.raises(ValueError, match="expected"):
            pq._weight_pointers(tp, dev)
    finally:
        tp["hidden"][1] = old
    assert pq._weight_pointers(tp, dev) == first
