"""The port's fused ResModule (bilinear_tpu_torch/ops/resmodule.py) against
the JAX package's: the plain versions against ``res_block_ref`` and against
the Pallas kernels K3/K4 run in interpret mode, and the autograd Function
against torch autograd (recipe of tests/test_pallas_resmodule.py).

Tolerances. f32: the same f32 arithmetic summed in another order, 1e-5
(forward) and 1e-4 (gradients, which sum over all rows). bf16: a value at a
bf16 rounding boundary may round one step apart and carry through the
block, so the gate is on mean |diff| (2e-3 of mean |ref|) and max |diff|
(0.1 of mean |ref|, about ten bf16 steps of a typical value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.ops.pallas import resmodule as jrm
from bilinear_tpu_torch.ops import resmodule as prm
from torch_port_fixtures import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(b, h, w, ci, co, seed=0):
    """x, params and scrambled running stats as numpy, from one seed."""
    rng = np.random.RandomState(seed)
    ch = co // 2

    def u(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    p = dict(
        w1=u((ci, ch), ci), b1=u((ch,), ci),
        w2=u((9, ch, ch), 9 * ch), b2=u((ch,), 9 * ch),
        w3=u((ch, co), ch), b3=u((co,), ch),
        g1=(1 + 0.3 * rng.randn(ci)).astype(np.float32),
        be1=(0.3 * rng.randn(ci)).astype(np.float32),
        g2=(1 + 0.3 * rng.randn(ch)).astype(np.float32),
        be2=(0.3 * rng.randn(ch)).astype(np.float32),
        g3=(1 + 0.3 * rng.randn(ch)).astype(np.float32),
        be3=(0.3 * rng.randn(ch)).astype(np.float32),
    )
    if ci != co:
        p["skip_w"] = u((ci, co), ci)
        p["skip_b"] = u((co,), ci)
    stats = []
    for c in (ci, ch, ch):
        stats += [(0.2 * rng.randn(c)).astype(np.float32),
                  rng.uniform(0.5, 1.5, c).astype(np.float32)]
    x = rng.randn(b, h, w, ci).astype(np.float32)
    return x, p, stats


def _jax(x, p, stats):
    return (jnp.asarray(x), jrm.ResParams(**{k: jnp.asarray(v)
                                             for k, v in p.items()}),
            jrm.BatchStats(*(jnp.asarray(s) for s in stats)))


def _torch(x, p, stats):
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    return (t(x), prm.ResParams(**{k: t(v) for k, v in p.items()}),
            prm.BatchStats(*(t(s) for s in stats)))


def _close(out, ref, dtype_name, tol32=1e-5):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(out, ref, rtol=tol32, atol=tol32)
        return
    d = np.abs(out - ref)
    scale = float(np.abs(ref).mean())
    assert d.mean() <= 2e-3 * scale, (d.mean(), scale)
    assert d.max() <= 0.1 * scale, (d.max(), scale)


SHAPES = [(2, 8, 8, 16, 16), (2, 8, 8, 8, 16), (5, 16, 16, 16, 16)]
SHAPE_IDS = ["identity", "skip", "odd-batch"]


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_forward_matches_jax_ref(shape, train, dtype_name):
    x, p, stats = _case(*shape)
    jd, td = DTYPES[dtype_name]
    # JAX's res_block_ref multiplies by the f32 weights; K3 (and the port)
    # by the weights rounded to the working type. Round them here so that
    # both see the same operands.
    for k in ("w1", "w2", "w3", "skip_w"):
        if k in p:
            p[k] = np.asarray(jnp.asarray(p[k]).astype(jd), np.float32)
    jx, jp, js = _jax(x, p, stats)
    tx, tp, ts = _torch(x, p, stats)
    ref, ref_stats = jrm.res_block_ref(jx, jp, train=train,
                                       stats=None if train else js, dtype=jd)
    out, out_stats = prm.res_block_ref(tx, tp, train=train,
                                       stats=None if train else ts, dtype=td)
    assert out.dtype == td
    _close(out.float().numpy(), ref, dtype_name)
    for a, b in zip(out_stats, ref_stats):
        _close(a.numpy(), np.asarray(b), "float32",
               tol32=1e-5 if dtype_name == "float32" else 1e-2)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_forward_matches_jax_kernel(shape, train, dtype_name):
    """K3's body (Pallas, interpret mode) against the port's plain version."""
    x, p, stats = _case(*shape, seed=1)
    jd, td = DTYPES[dtype_name]
    jx, jp, js = _jax(x, p, stats)
    tx, tp, ts = _torch(x, p, stats)
    if train:
        ref, ref_stats = jrm.res_block_train(jx, jp, dtype=jd, interpret=True)
    else:
        ref = jrm.res_block_eval(jx, jp, js, dtype=jd, interpret=True)
    out, out_stats = prm.res_block_ref(tx, tp, train=train,
                                       stats=None if train else ts, dtype=td)
    _close(out.float().numpy(), ref, dtype_name)
    if train:
        for a, b in zip(out_stats, ref_stats):
            _close(a.numpy(), np.asarray(b), "float32",
                   tol32=1e-5 if dtype_name == "float32" else 1e-2)


def _jax_kernel_grads(x, p, probe, dtype):
    jx, jp, _ = _jax(x, p, [np.zeros(1)] * 6)

    def loss(xx, pp):
        out, _ = jrm.res_block_train(xx, pp, dtype=dtype, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * probe)

    return jax.grad(loss, argnums=(0, 1))(jx, jp)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES[:2], ids=SHAPE_IDS[:2])
def test_plain_backward_matches_jax_kernel(shape, dtype_name):
    """K4's body (the Pallas custom_vjp, interpret mode) against
    res_block_bwd_ref on the same x, parameters and output gradient."""
    x, p, _ = _case(*shape, seed=2)
    jd, td = DTYPES[dtype_name]
    probe = np.random.RandomState(7).randn(*shape[:3], shape[4]) \
        .astype(np.float32)
    gx_ref, gp_ref = _jax_kernel_grads(x, p, jnp.asarray(probe), jd)
    tx, tp, _ = _torch(x, p, [np.zeros(1)] * 6)
    _, st = prm.res_block_ref(tx, tp, train=True, dtype=td)
    gx, gp = prm.res_block_bwd_ref(tx, torch.from_numpy(probe), tp, st,
                                   dtype=td)
    assert gx.dtype == td
    _close(gx.float().numpy(), gx_ref, dtype_name, tol32=1e-4)
    for name in jrm.ResParams._fields:
        a, b = getattr(gp, name), getattr(gp_ref, name)
        if a is None and b is None:
            continue
        _close(a.numpy(), np.asarray(b).reshape(a.shape), dtype_name,
               tol32=1e-4)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=SHAPE_IDS[:2])
def test_plain_backward_matches_torch_autograd(shape):
    """res_block_bwd_ref against autograd through res_block_ref, f32."""
    x, p, _ = _case(*shape, seed=3)
    probe = torch.from_numpy(np.random.RandomState(8).randn(
        *shape[:3], shape[4]).astype(np.float32))
    tx, tp, _ = _torch(x, p, [np.zeros(1)] * 6)
    tx.requires_grad_(True)
    for t in tp:
        if t is not None:
            t.requires_grad_(True)
    out, st = prm.res_block_ref(tx, tp, train=True, dtype=torch.float32)
    (out * probe).sum().backward()
    with torch.no_grad():
        gx, gp = prm.res_block_bwd_ref(tx, probe, tp, st, dtype=torch.float32)
    np.testing.assert_allclose(gx.numpy(), tx.grad.numpy(), rtol=1e-4,
                               atol=1e-4)
    for name, t in zip(prm.ResParams._fields, tp):
        if t is None:
            assert getattr(gp, name) is None
            continue
        np.testing.assert_allclose(getattr(gp, name).numpy(), t.grad.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_autograd_function_on_cpu_runs_plain_versions(dtype_name):
    """res_block_train on CPU tensors: forward = res_block_ref, backward =
    res_block_bwd_ref exactly; the stats outputs carry no gradient; no
    kernel counter moves."""
    x, p, _ = _case(2, 8, 8, 8, 16, seed=4)
    _, td = DTYPES[dtype_name]
    tx, tp, _ = _torch(x, p, [np.zeros(1)] * 6)
    probe = torch.from_numpy(np.random.RandomState(9).randn(2, 8, 8, 16)
                             .astype(np.float32))
    before = (prm.LAUNCHES_FWD_TRAIN, prm.LAUNCHES_BWD)
    xr = tx.clone().requires_grad_(True)
    pr = prm.ResParams(*(t.clone().requires_grad_(True) for t in tp))
    assert pr.skip_w is not None
    out, st = prm.res_block_train(xr, pr, dtype=td)
    assert all(not s.requires_grad for s in st)
    (out.float() * probe).sum().backward()
    ref_out, ref_st = prm.res_block_ref(tx, tp, train=True, dtype=td)
    assert torch.equal(out, ref_out)
    gx, gp = prm.res_block_bwd_ref(tx, probe, tp, ref_st, dtype=td)
    assert torch.equal(xr.grad.to(td), gx)
    for name, t in zip(prm.ResParams._fields, pr):
        assert torch.equal(t.grad, getattr(gp, name)), name
    assert (prm.LAUNCHES_FWD_TRAIN, prm.LAUNCHES_BWD) == before


def test_cuda_wrapper_refuses_a_cpu_tensor():
    x, p, _ = _case(2, 8, 8, 64, 128)
    tx, tp, _ = _torch(x, p, [np.zeros(1)] * 6)
    with pytest.raises(ValueError, match="CUDA"):
        prm._fwd_cuda(tx, tp, True, None, torch.bfloat16)


# ---------------------------------------------------------------------------
# The wrapper's interface: weights read where PyTorch keeps them, running
# statistics updated in place, one-pass statistics.
# ---------------------------------------------------------------------------


def _module(ci, co, momentum=0.1, fused=True, seed=0):
    from bilinear_tpu_torch.models.hourglass_torch7 import ResModule

    torch.manual_seed(seed)
    mod = ResModule(ci, co, momentum=momentum, fused=fused)
    with torch.no_grad():
        for bn in (mod.resSeq[0], mod.resSeq[3], mod.resSeq[6]):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_(0, 0.3)
            bn.running_mean.normal_(0, 0.2)
            bn.running_var.uniform_(0.5, 1.5)
    return mod


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("ci,co", [(16, 16), (8, 16)], ids=["identity", "skip"])
def test_strided_param_views_equal_contiguous_copies(ci, co, dtype_name):
    """res_block_train / res_block_eval fed ResModule.res_params()' strided
    views of the conv weights give the bits of contiguous copies, forward
    and gradients."""
    _, td = DTYPES[dtype_name]
    mod = _module(ci, co)
    views = mod.res_params()
    assert not views.w1.is_contiguous() and not views.w2.is_contiguous()
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 8, 8, ci)
                         .astype(np.float32))
    probe = torch.from_numpy(np.random.RandomState(6).randn(2, 8, 8, co)
                             .astype(np.float32))
    stats = prm.BatchStats(*(t for bn in (mod.resSeq[0], mod.resSeq[3],
                                          mod.resSeq[6])
                             for t in (bn.running_mean, bn.running_var)))
    results = []
    for contiguous in (False, True):
        p = prm.ResParams(*(None if t is None else
                            (t.detach().contiguous() if contiguous
                             else t.detach()).requires_grad_(True)
                            for t in views))
        xr = x.clone().requires_grad_(True)
        out, st = prm.res_block_train(xr, p, dtype=td)
        (out.float() * probe).sum().backward()
        with torch.no_grad():
            ev = prm.res_block_eval(x, p, stats, dtype=td)
        results.append((out, st, xr.grad, [t.grad for t in p if t is not None],
                        ev))
    (o1, s1, gx1, gp1, e1), (o2, s2, gx2, gp2, e2) = results
    assert torch.equal(o1, o2) and torch.equal(e1, e2)
    assert torch.equal(gx1, gx2)
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    for a, b in zip(gp1, gp2):
        assert torch.equal(a, b)


def test_inplace_running_update_equals_update_running_stats():
    """momentum=0.1: the update done inside res_block_train is
    core.norm.update_running_stats bit for bit."""
    from bilinear_tpu_torch.core.norm import update_running_stats

    mod = _module(8, 16)
    bns = (mod.resSeq[0], mod.resSeq[3], mod.resSeq[6])
    ref = [torch.nn.BatchNorm2d(bn.num_features, momentum=0.1) for bn in bns]
    for r, bn in zip(ref, bns):
        r.load_state_dict(bn.state_dict())
    x = torch.from_numpy(np.random.RandomState(11).randn(2, 8, 8, 8)
                         .astype(np.float32))
    running = prm.RunningStats(tuple(bn.running_mean for bn in bns),
                               tuple(bn.running_var for bn in bns),
                               tuple(bn.num_batches_tracked for bn in bns),
                               0.1)
    with torch.no_grad():
        _, st = prm.res_block_train(x, mod.res_params(), dtype=torch.float32,
                                    running=running)
    for r, (m, v) in zip(ref, ((st.m1, st.v1), (st.m2, st.v2),
                               (st.m3, st.v3))):
        update_running_stats(r, m, v, 2 * 8 * 8)
    for r, bn in zip(ref, bns):
        assert torch.equal(r.running_mean, bn.running_mean)
        assert torch.equal(r.running_var, bn.running_var)
        assert int(bn.num_batches_tracked) == int(r.num_batches_tracked) == 1


@pytest.mark.parametrize("momentum", [0.1, None], ids=["momentum", "cumulative"])
def test_fused_module_running_stats_follow_the_standard_module(momentum):
    """ResModule(fused=True) in training leaves its BN buffers where the
    standard module (torch's own BatchNorm) leaves them; a numeric momentum
    goes through res_block_train, momentum=None through the Python path."""
    fused = _module(8, 16, momentum=momentum, fused=True)
    std = _module(8, 16, momentum=momentum, fused=False)
    std.load_state_dict(fused.state_dict())
    x = torch.from_numpy(np.random.RandomState(12).randn(2, 8, 8, 8)
                         .astype(np.float32)).permute(0, 3, 1, 2)
    calls = []
    orig = prm.res_block_train

    def spy(*a, **kw):
        calls.append(kw.get("running"))
        return orig(*a, **kw)

    prm.res_block_train = spy
    try:
        for _ in range(2):
            fused.train()(x)
            std.train()(x)
    finally:
        prm.res_block_train = orig
    assert all((r is None) == (momentum is None) for r in calls)
    for (k, a), (_, b) in zip(fused.state_dict().items(),
                              std.state_dict().items()):
        if "running" in k or "num_batches" in k:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_running_update_needs_a_numeric_momentum():
    mod = _module(8, 16)
    bns = (mod.resSeq[0], mod.resSeq[3], mod.resSeq[6])
    running = prm.RunningStats(tuple(bn.running_mean for bn in bns),
                               tuple(bn.running_var for bn in bns),
                               tuple(bn.num_batches_tracked for bn in bns),
                               None)
    with pytest.raises(ValueError, match="momentum"):
        prm.res_block_train(torch.zeros(1, 4, 4, 8), mod.res_params(),
                            dtype=torch.float32, running=running)


@pytest.mark.parametrize("n", [128, 700, 32768])
def test_merged_tile_stats_equal_two_pass_stats(n):
    """Per-tile (count, mean, M2) merged in a fixed order against the
    two-pass ``_stats``, f32, on columns whose |mean| / std is 100: 1e-6
    relative (of the mean, and of the variance)."""
    rng = np.random.RandomState(n)
    std = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    sign = np.where(rng.rand(16) < 0.5, -1.0, 1.0).astype(np.float32)
    h = torch.from_numpy((100.0 * std * sign
                          + std * rng.randn(n, 16)).astype(np.float32))
    m_ref, v_ref = prm._stats(h)
    m, v = prm.merged_tile_stats(h)
    assert m.dtype == v.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), m_ref.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The C entries' argument array is filled by the slot names the library
# reports.
# ---------------------------------------------------------------------------


def test_slot_array_follows_the_librarys_names():
    names = ["bf16", "x", "w1", "w1_si", "w1_so", "stream"]
    w = torch.zeros(4, 6).t()  # a (6, 4) view with strides (1, 6)
    vals = dict(prm._weight("w1", w, (6, 4), w.device), stream=7, x=5, bf16=1)
    assert list(prm._slot_array(names, vals)) == [1, 5, w.data_ptr(), 1, 6, 7]
    w9 = prm._weight("dw2", None, (9, 4, 4), w.device)
    assert w9 == {"dw2": 0, "dw2_st": 0, "dw2_si": 0, "dw2_so": 0}


@pytest.mark.parametrize("change", ["missing", "unknown", "renamed"])
def test_slot_array_refuses_other_names(change):
    names = ["bf16", "x", "stream"]
    vals = {"bf16": 1, "x": 5, "stream": 7}
    if change == "missing":
        del vals["x"]
    elif change == "unknown":
        vals["gout"] = 3
    else:
        vals["xx"] = vals.pop("x")
    with pytest.raises(RuntimeError, match="argument slots differ"):
        prm._slot_array(names, vals)


def test_weight_slots_refuse_another_shape_or_type():
    with pytest.raises(ValueError, match="w3"):
        prm._weight("w3", torch.zeros(4, 6), (6, 4), torch.device("cpu"))
    with pytest.raises(ValueError, match="w3"):
        prm._weight("w3", torch.zeros(6, 4, dtype=torch.bfloat16), (6, 4),
                    torch.device("cpu"))
