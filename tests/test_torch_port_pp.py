"""The port's pipeline parallelism (bilinear_tpu_torch/parallel/pp.py) on
the CPU, over ``["cpu"] * S`` stage meshes, against the JAX package's
``parallel/pp.py`` (on its 8 virtual CPU devices) and against the port's
own one-device paths.

Tolerances: the eval-mode forward is a re-scheduling of the same math, so
the port's pipelined heatmaps equal the port's ``MainModel`` bit for bit,
and JAX's ``pipeline_forward`` within 1e-4 of the heatmaps' largest value
(the two packages' convolutions sum in another order; the eval forward
parity of tests/test_torch_port_hourglass.py holds the same model at
1e-4). The int8 pipeline equals the port's int8 ``MainModel`` bit for
bit. ``pipeline_end2end``: pose_img within 1e-3 heatmap cells, the
normalized 3D pose within 1e-4 of its largest value (the End2End eval
gates of tests/test_torch_port_end2end.py), and the port's ``End2End``
bit for bit. The GPipe train step against JAX's ``make_pp_loss_fn``:
loss rel 1e-5 (JAX's own gate); gradients within 1e-2 of each leaf's
largest value, leaves below 1e-6 (conv biases in front of a BN, zero in
exact arithmetic) not compared: the randomly initialised net's f32
gradients are ill-conditioned (the stem's skip conv sat 6.1e-3 apart,
the other leaves below 1.5e-3; ROADMAP.md Queue 3). Against the port's
one-process step accumulated over the same microbatches, the exactness
check: loss rel 1e-6, clipped gradients within 1e-5 of each leaf's
largest value, BN statistics rtol 2e-4 / atol 2e-5, and the parameters
after RMSprop's first step (which amplifies gradients near eps) where
|g| > 3e-5 at rtol 2e-3, atol 2e-4 (JAX's gates).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.parallel import pp as jpp
from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
from bilinear_tpu_torch.parallel import pp
from bilinear_tpu_torch.train.hourglass import heatmap_loss
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread  # noqa: F401

N_STACKS, FEATURES, DEPTH, RES = 4, 16, 2, 64
SIZE = dict(n_stacks=N_STACKS, features=FEATURES, depth=DEPTH)


@pytest.fixture(scope="module")
def variables():
    """JAX MainModel variables (a seeded port initialisation carried over;
    flax's own init costs ~12 s of eager compiles here) with the BN
    statistics moved off init, as JAX's test does."""
    m = MainModel(**SIZE, generator=torch.Generator().manual_seed(0))
    params, stats = wt.hourglass_torch7_to_jax(m.state_dict())
    v = {"params": params, "batch_stats": stats}
    return jax.tree.map(lambda a: a + np.float32(0.01)
                        if a.dtype == np.float32 else a, v)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(8, RES, RES, 3).astype(np.float32)


def _port_model(variables, **kw):
    m = MainModel(**SIZE, **kw)
    m.load_state_dict(wt.hourglass_torch7_from_jax(
        variables["params"], variables["batch_stats"]))
    return m.eval()


@pytest.fixture(scope="module")
def port_ref(variables, images):
    with torch.no_grad():
        return _port_model(variables)(torch.from_numpy(images))[-1].numpy()


@pytest.mark.parametrize("stages,microbatches",
                         [(4, 4), (2, 2), (4, 1), (1, 1)])
def test_forward_matches_jax_and_main_model(variables, images, port_ref,
                                            stages, microbatches):
    got = pp.pipeline_forward(
        variables, torch.from_numpy(images), ["cpu"] * stages, **SIZE,
        microbatches=microbatches).numpy()
    np.testing.assert_array_equal(got, port_ref)
    want = np.asarray(jpp.pipeline_forward(
        variables, jnp.asarray(images), jpp.make_stage_mesh(stages=stages),
        **SIZE, microbatches=microbatches))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_make_pipeline_fn_is_reusable_and_views_the_model(variables,
                                                           images, port_ref):
    model = _port_model(variables)
    fn = pp.make_pipeline_fn(model, pp.make_stage_mesh(["cpu"] * 2),
                             microbatches=2)
    x = torch.from_numpy(images)
    np.testing.assert_array_equal(fn(x).numpy(), port_ref)
    np.testing.assert_array_equal(fn(x).numpy(), port_ref)
    # The blocks are views: no weight was copied.
    stack = pp.StackBlock(model, 1)
    assert stack.modules()[0] is model.hgArray[1]
    assert len(pp.StackBlock(model, N_STACKS - 1).modules()) == 3


def test_int8_pipeline_equals_int8_model(variables, images):
    x = torch.from_numpy(images)
    with torch.no_grad():
        want = _port_model(variables, quantize="int8")(x)[-1]
    got = pp.pipeline_forward(variables, x, ["cpu"] * 2, **SIZE,
                              microbatches=2, quantize="int8")
    assert torch.equal(got, want)


def test_errors_are_jax_s(variables, images):
    x = torch.from_numpy(images)
    with pytest.raises(ValueError, match="3 stages do not divide 4 stacks"):
        pp.pipeline_forward(variables, x, ["cpu"] * 3, **SIZE)
    with pytest.raises(ValueError, match="batch 8 does not divide 3"):
        pp.pipeline_forward(variables, x, ["cpu"] * 2, **SIZE,
                            microbatches=3)
    with pytest.raises(ValueError, match="only 2 devices are available"):
        pp.make_stage_mesh(["cpu"] * 2, stages=99)


def test_split_and_merge_match_jax(variables):
    stem, stacked = wt.split_pipeline_variables(variables, N_STACKS,
                                                features=FEATURES)
    jstem, jstacked = jpp.split_pipeline_variables(variables, N_STACKS,
                                                   features=FEATURES)
    for a, b in zip(jax.tree.leaves((stem, stacked)),
                    jax.tree.leaves((jstem, jstacked))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(jax.tree.map(np.asarray, (stem, stacked))) \
        == jax.tree.structure(jax.tree.map(np.asarray, (jstem, jstacked)))
    merged = wt.merge_pipeline_variables(stem, stacked, N_STACKS)
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree.structure(merged) == jax.tree.structure(
        jax.tree.map(np.asarray, variables))


def test_pipeline_end2end_matches_jax_and_end2end():
    rng = np.random.RandomState(1)
    imgs = rng.rand(2, 256, 256, 3).astype(np.float32)
    centers = np.full((2, 2), 128.0, np.float32)
    scales = np.full((2,), 1.28, np.float32)
    mean_p = np.zeros(32, np.float32)
    std_p = np.ones(32, np.float32)
    model = End2End(**SIZE, generator=torch.Generator().manual_seed(3))
    v = dict(zip(("params", "batch_stats"),
                 wt.end2end_to_jax(model.state_dict(), "torch7")))
    jp2, jp3 = jpp.pipeline_end2end(
        v, jnp.asarray(imgs), jnp.asarray(centers), jnp.asarray(scales),
        jnp.asarray(mean_p), jnp.asarray(std_p),
        jpp.make_stage_mesh(stages=2), **SIZE, microbatches=2)
    p2, p3 = pp.pipeline_end2end(v, torch.from_numpy(imgs), centers, scales,
                                 mean_p, std_p, ["cpu"] * 2, **SIZE,
                                 microbatches=2)
    cell = 256 / 64
    assert np.abs(p2.numpy() - np.asarray(jp2)).max() <= 1e-3 * cell
    assert np.abs(p3.numpy() - np.asarray(jp3)).max() <= \
        1e-4 * np.abs(np.asarray(jp3)).max()
    model.eval()
    with torch.no_grad():
        _, q2, q3 = model(torch.from_numpy(imgs), torch.from_numpy(centers),
                          torch.from_numpy(scales), torch.from_numpy(mean_p),
                          torch.from_numpy(std_p))
    assert torch.equal(p2, q2) and torch.equal(p3, q3)


def test_train_step_matches_jax_and_accumulated_step(variables, images):
    """(S, M) = (2, 2): the GPipe step against JAX's PP loss gradients and
    against the port's one-process step accumulated over the same two
    microbatches."""
    stages = micro = 2
    x = torch.from_numpy(images)
    targets = np.random.RandomState(1).rand(8, 16, RES // 4, RES // 4) \
        .astype(np.float32)
    t = torch.from_numpy(targets)

    model = _port_model(variables)
    step = pp.make_pp_train_step(model, ["cpu"] * stages,
                                 microbatches=micro)
    loss = float(step(x, t))
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}  # clipped by the step
    after = model.state_dict()
    # The same loss on another copy, its gradients before any clip.
    raw_model = _port_model(variables)
    raw_loss = pp.make_pp_loss_fn(raw_model, ["cpu"] * stages, micro)(x, t)
    raw_loss.backward()
    raw = {k: p.grad for k, p in raw_model.named_parameters()
           if p.grad is not None}

    # JAX's PP loss and gradients.
    stem_v, stacked_v = jpp.split_pipeline_variables(
        variables, N_STACKS, features=FEATURES)
    loss_fn = jpp.make_pp_loss_fn(jpp.make_stage_mesh(stages=stages),
                                  **SIZE, microbatches=micro)
    params = {"stem": stem_v["params"], "stacks": stacked_v["params"]}
    (jloss, _), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, stem_v["batch_stats"], stacked_v["batch_stats"],
        jnp.asarray(images), jnp.asarray(targets))
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    assert float(raw_loss) == loss
    merged = wt.merge_pipeline_variables(
        {"params": jax.tree.map(np.asarray, jg["stem"])},
        {"params": jax.tree.map(np.asarray, jg["stacks"])}, N_STACKS)
    jgrads = wt.hourglass_torch7_from_jax(
        merged["params"], jax.tree.map(np.asarray,
                                       variables["batch_stats"]))
    for k, g in raw.items():
        scale = float(jgrads[k].abs().max())
        if scale > 1e-6:  # a conv bias before a BN: noise on both sides
            assert float((g - jgrads[k]).abs().max()) <= 1e-2 * scale, k

    # The port in one process, gradients accumulated over the microbatches.
    ref = _port_model(variables).train()
    from bilinear_tpu_torch.core.optim import hourglass_optimizer

    opt = hourglass_optimizer(ref.parameters())
    opt.zero_grad()
    total = 0.0
    for xm, tm in zip(x.chunk(micro), t.chunk(micro)):
        lm = heatmap_loss(ref(xm), tm) / micro
        lm.backward()
        total += float(lm)
    opt.step()
    rgrads = {k: p.grad.clone() for k, p in ref.named_parameters()
              if p.grad is not None}  # clipped by the step
    assert loss == pytest.approx(total, rel=1e-6)
    assert set(grads) == set(rgrads)
    for k, g in grads.items():
        scale = max(float(rgrads[k].abs().max()), 1e-12)
        assert (g - rgrads[k]).abs().max() <= 1e-5 * scale, k
    want = ref.state_dict()
    for k, v in after.items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)
        elif k in rgrads:
            m = rgrads[k].abs() > 3e-5
            np.testing.assert_allclose(v[m].numpy(), want[k][m].numpy(),
                                       rtol=2e-3, atol=2e-4, err_msg=k)
    # Exactly one RMSprop update covered the stem and every stack.
    assert step.optimizer.count == 1
