"""The port's pre-activation hourglass (bilinear_tpu_torch:
core/norm.BatchNorm2d, models/hourglass.py, the preact converters of
utils/weights, models/detectors.make_model, the H36M joint maps) against the
JAX package on the CPU, at a tiny size (2 stacks, 16 features, depth 2,
64-pixel inputs, batch 2), with n_modules 1 and 2.

Tolerances, each measured on these inputs before it was set:
- Eval forward: 5.0e-7 of max|ref| (one f32 sum order against another);
  gate 1e-4.
- Train forward: 5.7e-5 (n_modules 1) and 1.9e-4 (n_modules 2) of max|ref|.
  Train-mode BN at batch 2 divides by small per-channel deviations of a
  freshly initialised net, which magnifies rounding. Against a float64 run
  of the port, the port is 1.2e-5 / 1.8e-4 of max|ref| away and the JAX
  package 6.0e-5 / 3.0e-4: both sides, the JAX one more. Gate 5e-4.
- The rest is stated at each test.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.core.norm import TorchBatchNorm
from bilinear_tpu.models.hourglass import StackedHourglass as JaxHourglass
from bilinear_tpu.ops import joints as jjoints
from bilinear_tpu.utils.torch_compat import hourglass_to_torch_state
from bilinear_tpu_torch.core.norm import BatchNorm2d
from bilinear_tpu_torch.models.detectors import make_model
from bilinear_tpu_torch.models.hourglass import StackedHourglass
from bilinear_tpu_torch.ops import joints as pjoints
from bilinear_tpu_torch.train import hourglass as th
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread  # noqa: F401

SIZE = dict(n_stacks=2, features=16, depth=2)
JSIZE = dict(stacks=2, out_channels=16, compression_time=2)
CL = torch.channels_last


def _scramble(rng):
    """Non-trivial BN: gamma, beta and running statistics from ``rng``."""
    def scramble(path, leaf):
        name = str(path[-1].key)
        leaf = np.asarray(leaf)
        if name == "mean":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "bias" and path[-2].key == "bn":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return leaf
    return scramble


@functools.lru_cache(maxsize=None)
def _jax_vars(n_modules):
    v = JaxHourglass(**JSIZE, n_modules=n_modules).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)), train=False)
    scramble = _scramble(np.random.RandomState(0))
    params = jax.tree_util.tree_map_with_path(scramble, v["params"])
    stats = jax.tree_util.tree_map_with_path(scramble, v["batch_stats"])
    return n_modules, params, stats


@pytest.fixture(scope="module", params=[1, 2], ids=["m1", "m2"])
def jax_vars(request):
    return _jax_vars(request.param)


def _port(jax_vars):
    n_modules, params, stats = jax_vars
    model = StackedHourglass(**SIZE, n_modules=n_modules)
    model.load_state_dict(wt.hourglass_preact_from_jax(params, stats))
    return model


def _jax_model(n_modules):
    return JaxHourglass(**JSIZE, n_modules=n_modules)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    tgt = rng.rand(2, 16, 16, 16).astype(np.float32)  # (B, J, h, w)
    return x, tgt


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close_per_leaf(got, want, rel, what):
    """Every leaf within ``rel`` of the largest |value| of that leaf."""
    a, b = _leaves(got), _leaves(want)
    assert a.keys() == b.keys()
    worst = 0.0
    for k, ref in b.items():
        err = np.abs(a[k] - ref).max() / max(np.abs(ref).max(), 1e-30)
        worst = max(worst, err)
        assert err <= rel, (what, k, err)
    return worst


# ----------------------------------------------------------- joint maps


def test_joint_maps_match_jax():
    for name in ("FROM_MPII_TO_H36M", "FROM_H36M_TO_MPII",
                 "H36M16_FROM_MPII"):
        np.testing.assert_array_equal(getattr(pjoints, name),
                                      getattr(jjoints, name), err_msg=name)


# -------------------------------------------------------- cumulative BN


def test_cumulative_batchnorm_matches_flax():
    """Three train calls then one eval call against flax TorchBatchNorm
    (momentum=None): outputs within 1e-5 of max|ref| (measured at most
    2.1e-7), counts equal, running mean and variance within 1e-6 relative
    (measured at most 4.2e-7: a few f32 ulp)."""
    rng = np.random.RandomState(3)
    c = 8
    gamma = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    flax_bn = TorchBatchNorm(momentum=None)
    stats = flax_bn.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, c)),
                         train=False)["batch_stats"]
    params = {"scale": gamma, "bias": beta}
    bn = BatchNorm2d(c)
    assert bn.momentum is None
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
    for call in range(4):
        train = call < 3
        x = (rng.randn(3, 5, 7, c) * (1 + call) + call).astype(np.float32)
        if train:
            ref, mut = flax_bn.apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
            stats = mut["batch_stats"]
        else:
            ref = flax_bn.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=False)
        bn.train(train)
        with torch.no_grad():
            out = bn(torch.from_numpy(x).permute(0, 3, 1, 2)
                     .contiguous(memory_format=CL))
        ref = np.asarray(ref)
        err = np.abs(out.permute(0, 2, 3, 1).numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (call, err)
        assert int(bn.num_batches_tracked) == int(stats["count"]) == \
            min(call + 1, 3)
        for name, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            np.testing.assert_allclose(buf.numpy(), np.asarray(stats[name]),
                                       rtol=1e-6, atol=0, err_msg=name)


def test_cumulative_batchnorm_keeps_torch_state_dict_keys():
    assert list(BatchNorm2d(4).state_dict()) == list(
        torch.nn.BatchNorm2d(4).state_dict())


# ------------------------------------------------- StackedHourglass


def test_weights_round_trip_exactly_both_ways(jax_vars):
    n_modules, params, stats = jax_vars
    sd = wt.hourglass_preact_from_jax(params, stats)
    p2, s2 = wt.hourglass_preact_to_jax(sd)
    assert jax.tree.structure(p2) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    assert jax.tree.structure(s2) == jax.tree.structure(
        jax.tree.map(np.asarray, stats))
    for got, want in ((p2, params), (s2, stats)):
        a, b = _leaves(got), _leaves(want)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model = StackedHourglass(**SIZE, n_modules=n_modules,
                             generator=torch.Generator().manual_seed(1))
    sd_model = model.state_dict()
    sd2 = wt.hourglass_preact_from_jax(*wt.hourglass_preact_to_jax(sd_model))
    assert sd2.keys() == sd_model.keys()
    for k, v in sd_model.items():
        assert torch.equal(sd2[k], v), k
    cfg = wt.preact_config_of_jax(params)
    assert cfg == wt.preact_config_of_state_dict(sd_model) == dict(
        SIZE, n_modules=n_modules, n_joints=16)
    paths = list(wt.preact_param_paths(cfg))
    assert [k for k, _, _ in paths] == [k for k, _ in
                                        model.named_parameters()]
    assert len(paths) == len(jax.tree.leaves(params))


def test_reference_state_dict_names_load_strictly():
    """The JAX package's export to the reference's StackedHourglass
    state_dict (torch_compat.hourglass_to_torch_state) loads into the
    port's model with strict=True, in the same key order, and gives the
    same forward as the port's own converter."""
    # The reference's StackedHourglass has one ResUnit per slot.
    jax_vars = _jax_vars(1)
    _, params, stats = jax_vars
    ex = hourglass_to_torch_state(params, stats)
    model = StackedHourglass(**SIZE)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in ex.sd.items()}, strict=True)
    assert list(ex.sd) == list(model.state_dict())
    x, _ = _inputs(0)
    with torch.no_grad():
        a = model.eval()(torch.from_numpy(x))
        b = _port(jax_vars).eval()(torch.from_numpy(x))
    assert torch.equal(a, b)


def test_eval_forward_matches_jax(jax_vars):
    n_modules, params, stats = jax_vars
    x, _ = _inputs(0)
    ref = np.asarray(_jax_model(n_modules).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        train=False))
    with torch.no_grad():
        out = _port(jax_vars).eval()(torch.from_numpy(x))
    assert out.shape == (2, 2, 16, 16, 16) and out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_train_forward_and_running_stats_match_jax(jax_vars):
    """Train-mode heatmaps (gate in the module docstring) and the BN
    statistics after the forward: mean and variance within 5e-4 of each
    leaf's largest value, counts equal. Measured 6.0e-5 / 1.7e-4 (n_modules
    1 / 2), with the port 1.6e-5 / 1.5e-4 and JAX 5.6e-5 / 1.7e-4 from a
    float64 run of the port: the same conditioning as the forward."""
    n_modules, params, stats = jax_vars
    x, _ = _inputs(1)
    ref, mut = _jax_model(n_modules).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])
    model = _port(jax_vars).train()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    ref = np.asarray(ref)
    assert np.abs(out.numpy() - ref).max() <= 5e-4 * np.abs(ref).max()
    _, got = wt.hourglass_preact_to_jax(model.state_dict())
    _close_per_leaf(got, mut["batch_stats"], 5e-4, "batch_stats")


def _jax_loss_grads(n_modules):
    @jax.jit
    def fn(params, batch_stats, x, tgt):
        def loss_fn(p):
            out, mut = _jax_model(n_modules).apply(
                {"params": p, "batch_stats": batch_stats}, x, train=True,
                mutable=["batch_stats"])
            t = jnp.transpose(tgt, (0, 2, 3, 1))
            return (jnp.sum(jnp.mean(jnp.square(out - t[None]),
                                     axis=(1, 2, 3, 4))), mut["batch_stats"])

        (loss, st), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, grads, st
    return fn


def _port_grads(model, x, tgt, params):
    """(loss, gradients as a JAX-layout tree in f32); a parameter without a
    gradient (the last stack's after/skip heads, whose sum no output reads)
    counts as zeros, which is what JAX returns for it."""
    dt = next(model.parameters()).dtype
    loss = th.heatmap_loss(model(torch.from_numpy(x).to(dt)),
                           torch.from_numpy(tgt).to(dt))
    loss.backward()
    named = dict(model.named_parameters())
    grads = {}
    for key, path, kind in wt.preact_param_paths(
            wt.preact_config_of_jax(params)):
        p = named[key]
        g = (torch.zeros_like(p) if p.grad is None else p.grad).float()
        wt.put_leaf(grads, path, wt.conv_to_jax(g) if kind == "conv_w"
                    else g.numpy())
    return float(loss.detach()), grads


def test_gradients_match_jax(jax_vars):
    """Gradients of the sum-of-stacks MSE, against JAX and against a
    float64 run of the port on the same inputs. Measured per leaf, as a
    share of the leaf's largest |value|: n_modules 1, the port at most
    1.7e-4 from float64 and JAX 3.1e-4, the two 4.6e-4 apart; n_modules 2,
    median 2.9e-3 (port) and 6.8e-3 (JAX) from float64, at most 5.7e-2 and
    1.1e-1. A freshly initialised net in train mode at batch 2 is badly
    conditioned: BN biases whose shift the next train-mode BN removes but
    for a ReLU's gating have gradients that are small differences of large
    terms, and with twice the modules both f32 sides lose more digits.
    Gates: every leaf is within 1e-3 of float64 or at most twice as far
    from it as JAX (measured ratio at most 1.7 where the first fails); a
    leaf JAX gets within 1e-3 of float64 is within 1e-3 of JAX (every leaf
    at n_modules 1). The loss within 1e-5 relative (measured 3.2e-7). A
    ResUnit's skip-conv bias only shifts channels that the heads'
    train-mode BNs remove: its gradient is zero in exact arithmetic and
    rounding noise on both sides (norms 3e-8 to 1.3e-6), held below
    1e-5."""
    n_modules, params, stats = jax_vars
    x, tgt = _inputs(2)
    ref_loss, ref_grads, _ = _jax_loss_grads(n_modules)(params, stats, x,
                                                       tgt)
    loss, grads = _port_grads(_port(jax_vars).train(), x, tgt, params)
    exact = StackedHourglass(**SIZE, n_modules=n_modules,
                             dtype=torch.float64).double()
    exact.load_state_dict(wt.hourglass_preact_from_jax(params, stats))
    _, g64 = _port_grads(exact.train(), x, tgt, params)
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    a, r, e = _leaves(grads), _leaves(ref_grads), _leaves(g64)
    assert a.keys() == r.keys() == e.keys()
    checked = conditioned = 0
    for k, ref in r.items():
        if k.endswith("['skip']['bias']"):
            assert max(np.linalg.norm(a[k]), np.linalg.norm(ref)) < 1e-5, k
            continue
        scale = np.abs(e[k]).max()
        if scale == 0:  # the last stack's after/skip heads: no output
            assert not a[k].any() and not ref.any(), k
            continue
        checked += 1
        jax_gap = np.abs(ref - e[k]).max() / scale
        port_gap = np.abs(a[k] - e[k]).max() / scale
        assert port_gap <= max(1e-3, 2 * jax_gap), (k, port_gap, jax_gap)
        if jax_gap <= 1e-3:
            conditioned += 1
            err = np.abs(a[k] - ref).max() / np.abs(ref).max()
            assert err <= 1e-3, (k, err)
    if n_modules == 1:
        assert conditioned == checked, (conditioned, checked)


def test_make_model_builds_the_preact_variant_and_refuses_fused():
    model = make_model("preact", **SIZE)
    assert isinstance(model, StackedHourglass) and model.variant == "preact"
    with pytest.raises(ValueError, match="torch7 variant only"):
        make_model("preact", fused=True, **SIZE)
    with pytest.raises(ValueError, match="fused blocks exist"):
        th.HourglassTrainer(variant="preact", fused_blocks=True,
                            device="cpu", **SIZE).init_state(0)
