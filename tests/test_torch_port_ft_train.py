"""The port's H36M fine-tuning of the pre-activation hourglass against the
JAX package on the CPU: the frames as detector records and the synthetic
image tree; three train steps of HourglassTrainer(variant="preact",
joint_remap=FROM_H36M_TO_MPII, flip_prob=0.0) against the JAX trainer's
``_train_step`` with the same augmentation draws; and FT checkpoints that
each package resumes from the other's. Tiny model (2 stacks, 16 features,
depth 2), batches of 2, 256-pixel crops (the trainers' own size).

The JAX step draws its augmentation from a PRNG key. The test replaces its
two samplers (``ops.augment.sample_geometry`` and ``color_jitter_batch``)
with functions that return the port's draws, so both packages crop,
rotate and jitter alike; the jitter keeps the JAX function's own structure
(one ``lax.switch`` over the orders).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.data.h36m import load_h36m as jax_load_h36m
from bilinear_tpu.data.h36m_images import H36MImageRecords as JaxRecords
from bilinear_tpu.data.pipeline import MPIIHostPipeline as JaxPipeline
from bilinear_tpu.data.synthetic import write_h36m_dataset as \
    jax_write_h36m_dataset
from bilinear_tpu.core.state import TrainState as JaxTrainState
from bilinear_tpu.io import checkpoint as jckpt
from bilinear_tpu.ops import augment as jaug
from bilinear_tpu.ops.joints import FROM_H36M_TO_MPII as J_REMAP
from bilinear_tpu.train.hourglass import HourglassTrainer as JaxTrainer
from bilinear_tpu_torch.data.h36m import Task, load_h36m
from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
from bilinear_tpu_torch.io import checkpoint as pckpt
from bilinear_tpu_torch.models.detectors import make_model
from bilinear_tpu_torch.ops.joints import FROM_H36M_TO_MPII
from bilinear_tpu_torch.train import hourglass as th
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread  # noqa: F401

SIZE = dict(n_stacks=2, features=16, depth=2)
BATCH, CANVAS, STEPS = 2, 256, 3


@pytest.fixture(scope="module")
def h36m(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ft") / "Human3.6M")
    return write_h36m_dataset(root, n_train=8, n_valid=4, with_images=True)


# ---------------------------------------------------- records, images


def test_synthetic_image_tree_is_byte_equal_to_jax(h36m, tmp_path):
    theirs = jax_write_h36m_dataset(str(tmp_path / "jax"), n_train=8,
                                    n_valid=4, with_images=True)

    def tree(root):
        out = {}
        for d, _, files in os.walk(root):
            for f in files:
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
        return out

    mine, ref = tree(h36m), tree(theirs)
    # The valid split's first frames share the train split's names, so
    # 8 files hold the 12 frames, in both packages.
    assert sum(k.endswith(".jpg") for k in ref) == 8
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k] == ref[k], k


def test_image_records_match_jax(h36m):
    for task in (Task.Train, Task.Valid):
        mine = H36MImageRecords(load_h36m(h36m)[task], h36m)
        ref = JaxRecords(jax_load_h36m(h36m)[task], h36m)
        assert len(mine) == len(ref)
        for i in range(len(ref)):
            a, b = mine.record(i), ref.record(i)
            for field in ("image_name", "scale", "head", "img_idx", "r_idx"):
                assert getattr(a, field) == getattr(b, field), field
            for field in ("center", "keypoints", "valid"):
                x, y = getattr(a, field), getattr(b, field)
                assert x.dtype == y.dtype, field
                np.testing.assert_array_equal(x, y, err_msg=field)
            assert mine.image_path(a) == ref.image_path(b)
            assert os.path.exists(mine.image_path(a))


# ------------------------------------------------------- train steps


def _batches(h36m, n):
    records = H36MImageRecords(load_h36m(h36m)[Task.Train], h36m)
    pipe = MPIIHostPipeline(records, BATCH, canvas=CANVAS, shuffle=True,
                            seed=0, transport="u8")
    out = []
    for epoch in range(1, 4):
        out += list(pipe.epoch(epoch, prefetch=0))
    return out[:n]


def _draws(n):
    return [th.sample_augment(th.step_generator(0, 1, s + 1), BATCH,
                              flip_prob=0.0) for s in range(n)]


class _FixedDraws:
    """The JAX samplers, replaced: they return what ``set`` was given."""

    def __init__(self):
        self.geo = self.jit = None

    def geometry(self, key, batch, **kw):
        return jaug.AugmentParams(*self.geo)

    def jitter(self, key, imgs, **kw):
        fb, fc, fs, fh, order = self.jit
        ops = [lambda im: jaug.adjust_brightness(im, fb[:, None, None, None]),
               lambda im: jaug.adjust_contrast(im, fc[:, None, None, None]),
               lambda im: jaug.adjust_saturation(im, fs[:, None, None, None]),
               lambda im: jaug.adjust_hue(im, fh[:, None, None])]

        def seq(o):
            def run(im):
                for k in o:
                    im = ops[k](im)
                return im
            return run

        return jax.lax.switch(order, [seq(o) for o in jaug._ORDERS], imgs)


def _jax_args(augment):
    g, j = augment
    geo = tuple(jnp.asarray(t.numpy()) for t in g)
    jit = tuple(jnp.asarray(t.numpy()) for t in j[:4]) + (
        jnp.asarray(j.order, jnp.int32),)
    return geo, jit


def _jax_batch(batch):
    return {k: getattr(batch, k) for k in ("images", "centers", "scales",
                                           "keypoints", "valid")}


@pytest.fixture(scope="module")
def run(h36m, tmp_path_factory):
    """The JAX trainer from an initial state through STEPS steps; before
    each, the port's state is restored from the JAX state (through a JAX
    ``.save``) and takes the same step on the same batch and draws. One
    more batch is each checkpoint test's next step. The initial state is a
    seeded port initialisation carried over by hourglass_preact_to_jax
    into JAX's TrainState with the JAX trainer's optimizer (flax's own init
    costs ~16 s of eager compiles on the CPU; test_torch_port_ft.py holds the
    converted tree to flax's)."""
    jtrainer = JaxTrainer(variant="preact", joint_remap=J_REMAP,
                          flip_prob=0.0, **SIZE)
    jstate = JaxTrainState.create(*wt.hourglass_preact_to_jax(
        make_model("preact", generator=torch.Generator().manual_seed(0),
                   **SIZE).state_dict()), jtrainer.tx)
    fixed = _FixedDraws()
    rng = jax.random.PRNGKey(1)
    sync = str(tmp_path_factory.mktemp("sync"))

    def jax_step(state, batch, geo, jit):
        fixed.geo, fixed.jit = geo, jit
        return jtrainer._train_step(state, batch, rng)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaug, "sample_geometry", fixed.geometry)
        mp.setattr(jaug, "color_jitter_batch", fixed.jitter)
        step = jax.jit(jax_step)
        batches, draws = _batches(h36m, STEPS + 1), _draws(STEPS + 1)
        trainer = th.HourglassTrainer(variant="preact", device="cpu",
                                      joint_remap=FROM_H36M_TO_MPII,
                                      flip_prob=0.0, **SIZE)
        state = trainer.init_state(5)
        jloss, ploss, after = [], [], []
        for s in range(STEPS):
            jckpt.save_checkpoint(sync, s + 1, jstate)
            state.restore(pckpt.load_checkpoint(sync, s + 1))
            jstate, loss = step(jstate, _jax_batch(batches[s]),
                                *_jax_args(draws[s]))
            jloss.append(float(loss))
            ploss.append(float(trainer.train_step(
                state, trainer.batch_tensors(batches[s]), draws[s])))
            after.append((state.trees(), jstate))
        last = (batches[STEPS], draws[STEPS])

        def jax_next(js):
            return float(step(js, _jax_batch(last[0]),
                              *_jax_args(last[1]))[1])

        def port_next(ps):
            return float(trainer.train_step(ps, trainer.batch_tensors(last[0]),
                                            last[1]))

        yield dict(jtrainer=jtrainer, jstate=jstate, trainer=trainer,
                   state=state, jloss=jloss, ploss=ploss, after=after,
                   jax_next=jax_next, port_next=port_next)


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(v, np.float64))
                           for v in jax.tree.leaves(tree)])


def _close_trees(got, want, what):
    """The gates of the torch7 optimizer-step test: max |diff| below 0.02
    and a cosine above 0.999 over all leaves."""
    a, b = _flat(got), _flat(want)
    assert np.abs(a - b).max() < 0.02, what
    assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999, \
        what


def test_three_ft_steps_match_jax(run):
    """Each of three steps from the JAX state: the loss within 1e-4
    relative (measured at most 4.7e-6), and after it the parameters, BN
    statistics and RMSprop square_avg within the torch7 step test's gates
    (measured max |diff| at most 5.0e-3 / 1.1e-5 / 3.9e-8, cosines at
    least 1 - 1.2e-6 / 1 - 5.7e-13 / 1 - 9.2e-6). The step counter and
    RMSprop's count agree. RMSprop's first updates are about
    10 lr sign(g): a gradient that is rounding noise on both sides (a
    shift-only bias) moves by a full 2.5e-3 either way, which is why
    parameters are held to a few update quanta and not to rounding."""
    np.testing.assert_allclose(run["ploss"], run["jloss"], rtol=1e-4)
    for s, ((params, stats, opt), js) in enumerate(run["after"]):
        _close_trees(params, js.params, f"params after step {s + 1}")
        _close_trees(stats, js.batch_stats, f"batch_stats, step {s + 1}")
        _close_trees(opt["1"]["square_avg"], js.opt_state[1].square_avg,
                     f"square_avg after step {s + 1}")
        assert int(opt["1"]["count"]) == int(js.opt_state[1].count) == s + 1
    assert run["state"].step == int(run["jstate"].step) == STEPS + 1


def _assert_trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, leaf in la:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(lb[path]),
                                      err_msg=jax.tree_util.keystr(path))


def test_port_ft_checkpoint_resumes_in_jax(run, tmp_path):
    """The port's FT 1.save through JAX resume_or_init_fast: the same
    trees, and the next step's loss within 1e-4 of the port's own
    (measured 6.9e-6)."""
    pdir = str(tmp_path / "parameter")
    params, stats, opt = run["state"].trees()
    pckpt.save_checkpoint(pdir, 1, params, stats, opt, step=run["state"].step)
    js, epoch = jckpt.resume_or_init_fast(run["jtrainer"].init_state,
                                          jax.random.PRNGKey(0), pdir)
    assert epoch == 1 and int(js.step) == run["state"].step
    _assert_trees_equal(js.params, params)
    _assert_trees_equal(js.batch_stats, stats)
    _assert_trees_equal(js.opt_state[1].square_avg, opt["1"]["square_avg"])
    assert int(js.opt_state[1].count) == STEPS
    assert run["jax_next"](js) == pytest.approx(
        run["port_next"](_port_copy(run, pdir)), rel=1e-4)


def _port_copy(run, pdir):
    state, _ = pckpt.resume_or_init(run["trainer"].init_state(7), pdir)
    return state


def test_jax_ft_checkpoint_resumes_in_port(run, tmp_path):
    """The JAX trainer's FT 1.save through the port's resume: the same
    trees back out of TrainState.trees, the same eval forward (within 1e-4
    of max|ref|; measured 2.6e-6) and the next step's loss within 1e-4 of
    JAX's (measured 6.5e-6)."""
    pdir = str(tmp_path / "parameter")
    js = run["jstate"]
    jckpt.save_checkpoint(pdir, 1, js)
    state = _port_copy(run, pdir)
    assert state.step == int(js.step) and state.optimizer.count == STEPS
    params, stats, opt = state.trees()
    payload = jckpt.load_checkpoint(pdir, 1)
    _assert_trees_equal(params, payload["state"]["params"])
    _assert_trees_equal(stats, payload["state"]["batch_stats"])
    _assert_trees_equal(opt, payload["optimizer"])
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(run["jtrainer"].model.apply(
        {"params": js.params, "batch_stats": js.batch_stats}, jnp.asarray(x),
        train=False))
    with torch.no_grad():
        out = state.model.eval()(torch.from_numpy(x)).numpy()
    state.model.train()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    assert run["port_next"](state) == pytest.approx(run["jax_next"](js),
                                                    rel=1e-4)


def test_jax_pipeline_gives_the_port_batches(h36m):
    """The two packages' pipelines feed both trainers the same canvases
    from the same records (the step test hands the port's to both)."""
    b = _batches(h36m, 1)[0]
    records = JaxRecords(jax_load_h36m(h36m)[Task.Train], h36m)
    jb = next(iter(JaxPipeline(records, BATCH, canvas=CANVAS, shuffle=True,
                               seed=0, transport="u8").epoch(1)))
    for k in ("images", "centers", "scales", "keypoints", "valid", "index"):
        np.testing.assert_array_equal(getattr(b, k), getattr(jb, k),
                                      err_msg=k)
