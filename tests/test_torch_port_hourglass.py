"""The port's torch7 detector (bilinear_tpu_torch/models/hourglass_torch7.py)
against the JAX package's MainModel(fused=True), at a tiny size (2 stacks,
16 features, depth 2, input 2 x 64 x 64), with weights carried by
hourglass_torch7_from_jax; and two clip + RMSprop steps against JAX
hourglass_optimizer (recipe of tests/test_hourglass_step_parity.py).

Tolerances: f32 on both sides; forwards and BN statistics 1e-4 (the same
arithmetic summed in another order through ~50 conv/BN layers), gradients
1e-3 relative to each tensor's norm. RMSprop's first updates are ~10 lr
sign(g), so after two steps parameters are held to a few update quanta
(max |diff| < 0.02) and a cosine above 0.999, as in the JAX package's own
step-parity test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.core.optim import hourglass_optimizer as jax_optimizer
from bilinear_tpu.core.state import TrainState as JaxTrainState
from bilinear_tpu.models.hourglass_torch7 import MainModel as JaxMainModel
from bilinear_tpu_torch.core.optim import hourglass_optimizer
from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
from bilinear_tpu_torch.train.hourglass import heatmap_loss
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread  # noqa: F401

CFG = dict(n_stacks=2, features=16, depth=2)


@pytest.fixture(scope="module")
def jax_vars():
    """Flax init with non-trivial BN: gamma/beta and running stats drawn
    from a numpy seed."""
    # fused=False gives the same variable tree, and initialises faster.
    v = JaxMainModel(**CFG).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)), train=False)
    rng = np.random.RandomState(0)

    def scramble(path, leaf):
        name = str(path[-1].key)
        leaf = np.asarray(leaf)
        if name == "mean":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "bias" and path[-2].key.startswith("bn"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(scramble, v["params"])
    stats = jax.tree_util.tree_map_with_path(scramble, v["batch_stats"])
    return params, stats


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    tgt = rng.rand(2, 16, 16, 16).astype(np.float32)  # (B, J, h, w)
    return x, tgt


def _port(jax_vars, fused):
    model = MainModel(**CFG, fused=fused)
    model.load_state_dict(wt.hourglass_torch7_from_jax(*jax_vars))
    return model


def _allclose_tree(a, b, rtol, atol):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, leaf in la:
        np.testing.assert_allclose(np.asarray(leaf, np.float64),
                                   np.asarray(lb[path], np.float64),
                                   rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_weights_round_trip_exactly_both_ways(jax_vars):
    params, stats = jax_vars
    sd = wt.hourglass_torch7_from_jax(params, stats)
    p2, s2 = wt.hourglass_torch7_to_jax(sd)
    _allclose_tree(p2, params, 0, 0)
    _allclose_tree(s2, stats, 0, 0)
    assert jax.tree.structure(s2) == jax.tree.structure(
        jax.tree.map(np.asarray, stats))
    sd_model = MainModel(**CFG, generator=torch.Generator().manual_seed(1)) \
        .state_dict()
    sd2 = wt.hourglass_torch7_from_jax(*wt.hourglass_torch7_to_jax(sd_model))
    assert sd2.keys() == sd_model.keys()
    for k, v in sd_model.items():
        assert torch.equal(sd2[k], v), k


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "standard"])
def test_eval_forward_matches_jax(jax_vars, fused):
    x, _ = _inputs()
    ref = JaxMainModel(**CFG, fused=True).apply(
        {"params": jax_vars[0], "batch_stats": jax_vars[1]}, jnp.asarray(x),
        train=False)
    model = _port(jax_vars, fused).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.shape == (2, 2, 16, 16, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "standard"])
def test_train_forward_and_running_stats_match_jax(jax_vars, fused):
    x, _ = _inputs(1)
    ref, mut = JaxMainModel(**CFG, fused=True).apply(
        {"params": jax_vars[0], "batch_stats": jax_vars[1]}, jnp.asarray(x),
        train=True, mutable=["batch_stats"])
    model = _port(jax_vars, fused).train()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    _, stats = wt.hourglass_torch7_to_jax(model.state_dict())
    _allclose_tree(stats, jax.tree.map(np.asarray, mut["batch_stats"]),
                   1e-4, 1e-5)


@jax.jit
def _jax_loss_grads(params, batch_stats, x, tgt):
    """Sum-of-stacks MSE of JAX MainModel(fused=True), its gradients and
    the updated BN statistics."""
    def loss_fn(p):
        out, mut = JaxMainModel(**CFG, fused=True).apply(
            {"params": p, "batch_stats": batch_stats}, x, train=True,
            mutable=["batch_stats"])
        t = jnp.transpose(tgt, (0, 2, 3, 1))
        return (jnp.sum(jnp.mean(jnp.square(out - t[None]),
                                 axis=(1, 2, 3, 4))), mut["batch_stats"])

    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return loss, grads, stats


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "standard"])
def test_gradients_match_jax(jax_vars, fused):
    x, tgt = _inputs(2)
    ref_loss, ref_grads, _ = _jax_loss_grads(*jax_vars, x, tgt)
    model = _port(jax_vars, fused).train()
    loss = heatmap_loss(model(torch.from_numpy(x)), torch.from_numpy(tgt))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    named = dict(model.named_parameters())
    paths = list(wt.torch7_param_paths(wt.torch7_config_of_jax(jax_vars[0])))
    assert len(paths) == len(jax.tree.leaves(ref_grads))
    # Every conv bias but the heatmap heads' only shifts channels that a
    # later train-mode BN removes: its gradient is zero in exact arithmetic
    # (norms 1e-8 to 1e-6 here on both sides), so it is held to that.
    shift_only = {f"{m}.bias" for m, mod in model.named_modules()
                  if isinstance(mod, torch.nn.Conv2d)
                  and not m.startswith("htmapArray.")}
    for key, path, kind in paths:
        g = named[key].grad
        g = wt.conv_to_jax(g) if kind == "conv_w" else g.numpy()
        r = np.asarray(wt.get_leaf(ref_grads, path))
        if key in shift_only:
            assert max(np.linalg.norm(g), np.linalg.norm(r)) < 1e-5, key
            continue
        err = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert err < 1e-3, (key, err)


def test_two_optimizer_steps_match_jax(jax_vars):
    tx = jax_optimizer(2.5e-4)
    state = JaxTrainState.create(jax_vars[0], jax_vars[1], tx)
    model = _port(jax_vars, True).train()
    opt = hourglass_optimizer(model.parameters(), 2.5e-4)
    for i in range(2):
        x, tgt = _inputs(10 + i)
        jl, grads, new_stats = _jax_loss_grads(state.params,
                                               state.batch_stats, x, tgt)
        state = state.apply_updates(tx, grads).replace(batch_stats=new_stats)
        loss = heatmap_loss(model(torch.from_numpy(x)), torch.from_numpy(tgt))
        opt.zero_grad()
        loss.backward()
        opt.step()
        assert float(loss.detach()) == pytest.approx(float(jl), rel=5e-3), i
    assert opt.count == int(state.opt_state[1].count) == 2
    params, _ = wt.hourglass_torch7_to_jax(model.state_dict())
    a = np.concatenate([np.ravel(v) for v in jax.tree.leaves(params)])
    b = np.concatenate([np.ravel(np.asarray(v))
                        for v in jax.tree.leaves(state.params)])
    assert np.abs(a - b).max() < 0.02
    assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999
