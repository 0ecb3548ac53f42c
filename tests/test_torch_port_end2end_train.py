"""The port's joint End2End training (bilinear_tpu_torch/train/end2end.py,
cli/train_end2end.py, cli/valid_end2end.py) against the JAX package on the
CPU, torch7 detector at a tiny size (2 stacks, 16 features, depth 2; the
lifting half at its full width), batches of 4 from the synthetic H36M tree
with images, 256-pixel crops. Not 2: a train-mode BN over two rows is
ill-conditioned (a feature whose two values nearly agree is normalized by
their difference), and the lifter's BNs turned the two packages' 1e-4
heatmap gap into 0.7% of 3D loss at batch 2.

Dropout is off on both sides: the JAX model is tests' NoDropoutEnd2End
(BilinearUnit(dropout=0.0)), the port's every nn.Dropout is set to p = 0.
The decode box (original image space) differs from the crop box (canvas
space) in every batch: a port that decoded with the crop box would lift
other keypoints.

The reference is JAX's own End2End step in float64 (``jax.enable_x64``):
``End2EndTrainer._train_step`` with ``dtype=float64``, its samplers
returning the port's draws. Its input stages cannot run in float64 (JAX's
crop_batch mixes f32 and f64 branches), so they run first in f32, as JAX's
step runs them (crop_batch, colour jitter, target heatmaps), and the step
is handed their results: its crop_batch, colour jitter and heatmap
rendering are replaced by pass-throughs. The port's preprocessing is held
to those f32 results, and every port step below takes them too.

At a random initialisation the joint loss's gradient is ill-conditioned
(the x10 soft-argmax of nearly flat heatmaps, the lifter's train-mode BN
over 4 rows): JAX's own f32 gradients sit a median 41% from its float64
ones, and a 1e-6 change of the crops moves the float64 gradients by 4%.
So nothing is held to JAX's f32 step. The port in float64 (the standard
model, on the same inputs) is held to JAX in float64 tightly, which checks
the logic apart from rounding; the port in f32 is held to JAX in float64
with the gates each test states. The JAX state is a seeded port
initialisation carried over by end2end_to_jax (flax's init costs ~20 s of
eager compiles here). Biases whose shift a train-mode BN removes (zero
gradient in exact arithmetic) are left out of the relative gradient gates.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from bilinear_tpu.core.state import TrainState as JaxTrainState
from bilinear_tpu.io import checkpoint as jckpt
from bilinear_tpu.ops import augment as jaug
from bilinear_tpu.ops.affine import crop_batch as jax_crop_batch
from bilinear_tpu.ops.heatmap import (keypoints_to_heatmap_space,
                                      render_heatmaps)
from bilinear_tpu.train import end2end as je
from bilinear_tpu.train.end2end import End2EndTrainer as JaxTrainer
from bilinear_tpu_torch.cli import train_end2end, valid_end2end, webcam
from bilinear_tpu_torch.data.h36m import Task, load_h36m
from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
from bilinear_tpu_torch.io import checkpoint as pckpt
from bilinear_tpu_torch.parallel.mesh import Mesh
from bilinear_tpu_torch.train import end2end as te
from bilinear_tpu_torch.train import hourglass as th
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import NoDropoutEnd2End, one_torch_thread

SIZE = dict(n_stacks=2, features=16, depth=2)
BATCH, CANVAS, STEPS = 4, 256, 3


@pytest.fixture(scope="module")
def h36m(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("e2e_train") / "Human3.6M")
    write_h36m_dataset(root, n_train=8, n_valid=2, with_images=True)
    return root, load_h36m(root)[Task.Train]


def _batches(root, train, n):
    pipe = MPIIHostPipeline(H36MImageRecords(train, root), BATCH,
                            canvas=CANVAS, shuffle=True, seed=0,
                            drop_last=True, transport="u8")
    out = []
    for epoch in range(1, 4):
        out += list(pipe.epoch(epoch, prefetch=0))
    return out[:n]


def _jax_batch(batch, train):
    idx = batch.index
    b = {k: getattr(batch, k) for k in ("images", "centers", "scales",
                                        "keypoints", "valid")}
    b.update(s_norm=train.s[idx], decode_centers=train.centers[idx],
             decode_scales=train.scales[idx])
    # Every sample's decode box is another box than its crop box.
    assert np.linalg.norm(b["decode_centers"] - b["centers"],
                          axis=1).min() > 1.0
    return b


def _jitter(jit, imgs):
    """JAX's colour jitter with the draws ``jit`` (brightness, contrast,
    saturation, hue, order)."""
    fb, fc, fs, fh, order = jit
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


@jax.jit
def _jax_inputs(batch, geo, jit):
    """The f32 crops (crop_batch with the scale jitter, then the colour
    jitter) and H36M-order target heatmaps (B, 16, 64, 64) that JAX's
    End2End step makes from ``batch`` with these draws."""
    b = batch["images"].shape[0]
    scales = batch["scales"] * geo[0]
    crops = jax_crop_batch(batch["images"], batch["centers"], scales,
                           jnp.zeros(b), res=256)
    hm_xy = keypoints_to_heatmap_space(
        jnp.nan_to_num(batch["keypoints"]), batch["centers"], scales,
        jnp.zeros(b))
    return _jitter(jit, crops), render_heatmaps(hm_xy, batch["valid"])


def _jax_draws(augment):
    geo = tuple(jnp.asarray(t.numpy()) for t in augment.geometry)
    j = augment.jitter
    jit = tuple(jnp.asarray(t.numpy()) for t in j[:4]) + (
        jnp.asarray(j.order, jnp.int32),)
    return geo, jit


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(v, np.float64))
                           for v in jax.tree.leaves(tree)])


def _floats(tree, dtype):
    """``tree`` with its floating leaves in ``dtype`` (numpy)."""
    return jax.tree.map(
        lambda a: np.asarray(a, dtype)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else
        np.asarray(a), tree)


def _recording(tx):
    """``tx``, whose state also holds the gradients it was last given."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax32(js64):
    """JAX's float64 step state as a standard f32 JAX TrainState (the
    optimizer's own state, rounded to f32), as a ``.save`` holds it."""
    return JaxTrainState(
        params=_floats(js64.params, np.float32),
        batch_stats=_floats(js64.batch_stats, np.float32),
        opt_state=_floats(js64.opt_state[0], np.float32),
        step=np.asarray(js64.step))


_LAX_CONV = jax.lax.conv_general_dilated


def _conv_as_matmul(lhs, rhs, window_strides, padding, lhs_dilation=None,
                    rhs_dilation=None, dimension_numbers=None, **kw):
    """``lax.conv_general_dilated`` for float64 NHWC x HWIO operands with
    explicit padding and no dilation, as one matmul over the shifted
    windows: the same sums, where XLA's own float64 convolution on the CPU
    runs ~50x slower than its f32 one."""
    if lhs.dtype != jnp.float64:
        return _LAX_CONV(lhs, rhs, window_strides, padding, lhs_dilation,
                         rhs_dilation, dimension_numbers, **kw)
    assert dimension_numbers == jax.lax.conv_dimension_numbers(
        lhs.shape, rhs.shape, ("NHWC", "HWIO", "NHWC"))
    assert not any(d not in (None, (1, 1)) for d in (lhs_dilation,
                                                     rhs_dilation))
    assert kw.get("feature_group_count", 1) == 1
    kh, kw_, cin, cout = rhs.shape
    (sh, sw), ((top, bottom), (left, right)) = window_strides, padding
    x = jnp.pad(lhs, ((0, 0), (top, bottom), (left, right), (0, 0)))
    oh = (x.shape[1] - kh) // sh + 1
    ow = (x.shape[2] - kw_) // sw + 1
    windows = jnp.concatenate(
        [x[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]
         for i in range(kh) for j in range(kw_)], axis=-1)
    return windows @ rhs.reshape(kh * kw_ * cin, cout)


def _payload(js64):
    """A ``.save`` payload of JAX's float64 step state, in float64."""
    return {"state": {"params": _floats(js64.params, np.float64),
                      "batch_stats": _floats(js64.batch_stats, np.float64)},
            "optimizer": _floats(serialization.to_state_dict(
                js64.opt_state[0]), np.float64),
            "step": int(js64.step)}


class _Reference:
    """JAX's End2End step in float64 on given f32 inputs: its samplers
    return ``geo``, and its crop_batch, colour jitter and heatmap
    rendering pass through the crops and H36M-order targets handed in as
    the batch's images and keypoints. Its float64 convolutions run as
    ``_conv_as_matmul``."""

    def __init__(self, train):
        self.trainer = JaxTrainer(variant="torch7", batch_size=BATCH,
                                  model_kw=SIZE, dtype=jnp.float64)
        self.trainer.model = NoDropoutEnd2End(variant="torch7",
                                              dtype=jnp.float64, **SIZE)
        self.trainer.tx = _recording(self.trainer.tx)
        self.stats = tuple(np.asarray(a, np.float64)
                           for a in (train.mean_part, train.std_part))
        self.geo = None
        self._step = jax.jit(self._run)

    def _run(self, state, batch, stats, geo):
        self.geo = geo
        return self.trainer._train_step(state, batch, stats,
                                        jax.random.PRNGKey(1))

    def state(self, js32):
        """The float64 step state of a standard f32 JAX TrainState."""
        with jax.enable_x64(True):
            params = jax.tree.map(jnp.asarray,
                                  _floats(js32.params, np.float64))
            return JaxTrainState(
                params=params,
                batch_stats=jax.tree.map(
                    jnp.asarray, _floats(js32.batch_stats, np.float64)),
                opt_state=(jax.tree.map(jnp.asarray, _floats(
                    js32.opt_state, np.float64)),
                    jax.tree.map(jnp.zeros_like, params)),
                step=jnp.asarray(js32.step, jnp.int32))

    def step(self, state, batch, inputs, geo):
        """(new float64 state, (loss, heatmap loss, 3D loss)), dispatched
        and not waited for."""
        crops, targets = inputs
        with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
            mp.setattr(jaug, "sample_geometry",
                       lambda key, b, **kw: jaug.AugmentParams(*self.geo))
            mp.setattr(jaug, "color_jitter_batch", lambda key, im, **kw: im)
            mp.setattr(je, "crop_batch", lambda im, *a, **kw: im)
            mp.setattr(je, "keypoints_to_heatmap_space",
                       lambda kp, *a, **kw: kp)
            mp.setattr(je, "render_heatmaps", lambda t, valid: t)
            mp.setattr(jax.lax, "conv_general_dilated", _conv_as_matmul)
            state, *losses = self._step(
                state, dict(batch, images=crops, keypoints=targets),
                self.stats, geo)
            return state, losses


def _port_step(trainer, state, raw, train, inputs, augment):
    """The port's train_step on ``raw`` with its preprocessing handing over
    ``inputs`` (JAX's f32 crops and H36M-order targets); its losses."""
    crops, targets = (torch.from_numpy(np.array(a)) for a in inputs)
    pb = trainer.batch_tensors(raw, train.s, train.centers, train.scales)
    dt = torch.promote_types(torch.float32, trainer.dtype)
    stats = tuple(torch.from_numpy(np.asarray(a)).to(dt)
                  for a in (train.mean_part, train.std_part))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(th, "preprocess_batch",
                   lambda *a, **kw: (crops, targets, None))
        return [float(v) for v in trainer.train_step(state, pb, stats,
                                                     augment)]


@pytest.fixture(scope="module")
def run(h36m, tmp_path_factory):
    """JAX's float64 step from its initial state through STEPS steps. Before
    each, the port's float64 standard model is restored from JAX's float64
    state, and the port's f32 state (fused=True: K3/K4's plain versions on
    the CPU) from it through a JAX ``.save`` (rounded to f32); both take
    the same step on the same inputs. The checkpoint tests resume the
    state before the last step and take that step."""
    root, train = h36m
    jstate0 = JaxTrainState.create(*wt.end2end_to_jax(
        te.End2EndTrainer(device="cpu", model_kw=SIZE).make_model(0)
        .state_dict(), "torch7"), JaxTrainer().tx)
    ref = _Reference(train)
    sync = str(tmp_path_factory.mktemp("sync"))
    batches = _batches(root, train, STEPS)
    draws = [te.sample_augment(0, 1, s + 1, BATCH) for s in range(STEPS)]
    jb = [_jax_batch(b, train) for b in batches]
    inputs = [tuple(np.asarray(a) for a in _jax_inputs(b, *_jax_draws(d)))
              for b, d in zip(jb, draws)]
    jstates, jlosses = [ref.state(jstate0)], []
    for s in range(STEPS):
        js, losses = ref.step(jstates[-1], jb[s], inputs[s],
                              _jax_draws(draws[s])[0])
        jstates.append(js)
        jlosses.append(losses)
    trainer64 = te.End2EndTrainer(variant="torch7", batch_size=BATCH,
                                  device="cpu", dtype=torch.float64,
                                  model_kw=SIZE)
    state64 = trainer64.init_state(5)
    _no_dropout(state64.model.double())
    trainer = te.End2EndTrainer(variant="torch7", batch_size=BATCH,
                                device="cpu", model_kw=dict(SIZE, fused=True))
    state = trainer.init_state(5)
    _no_dropout(state.model)
    steps = []
    for s in range(STEPS):
        js32 = _jax32(jstates[s])
        jckpt.save_checkpoint(sync, s + 1, js32)
        state.restore(pckpt.load_checkpoint(sync, s + 1))
        if s == STEPS - 1:
            resume = dict(jstate=js32, trees=state.trees(), step=state.step)
        state64.restore(_payload(jstates[s]))
        steps.append(dict(
            before=js32.params, jstate=jstates[s + 1],
            jloss=[float(v) for v in jlosses[s]],
            p64=_port_step(trainer64, state64, batches[s], train, inputs[s],
                           draws[s]),
            trees64=state64.trees(),
            p32=_port_step(trainer, state, batches[s], train, inputs[s],
                           draws[s]),
            trees32=state.trees()))

    def port_next(ps):
        return _port_step(trainer, ps, batches[-1], train, inputs[-1],
                          draws[-1])[0]

    return dict(jstate0=jstate0, trainer=trainer, state=state,
                state64=state64, steps=steps, inputs=inputs,
                noise=_shift_only(state.model,
                                  wt.converters_of(state.model)),
                batches=batches, draws=draws, resume=resume,
                jax_next=steps[-1]["jloss"][0], port_next=port_next)


def _rel(got, want):
    a, b = _flat(got), _flat(want)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _leaves(tree, noise=()):
    """Path -> float64 leaf, the noise leaves (JAX paths) left out."""
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)
            if jax.tree_util.keystr(p) not in noise}


def _leaf_gaps(got, want, noise=()):
    """Per-leaf |got - want| / |want| over the leaves but ``noise``."""
    a, b = _leaves(got, noise), _leaves(want, noise)
    assert a.keys() == b.keys()
    return {k: np.linalg.norm(a[k] - b[k]) / np.linalg.norm(b[k])
            for k in b}


def test_preprocessing_matches_jax(run, h36m):
    """The port's crops and target heatmaps of each step's batch and draws
    (th.preprocess_batch, what its train_step calls) against the f32 ones
    JAX's step makes: crops within 1e-5 (measured 1.1e-6), targets within
    1e-6 (1.5e-8) of JAX's."""
    _, train = h36m
    trainer = run["trainer"]
    for raw, aug, (crops, targets) in zip(run["batches"], run["draws"],
                                          run["inputs"]):
        pb = trainer.batch_tensors(raw, train.s, train.centers, train.scales)
        mine, tgt, _ = th.preprocess_batch(
            pb["images"], pb["centers"], pb["scales"], pb["keypoints"],
            pb["valid"], th.Augment(aug.geometry, aug.jitter))
        assert np.abs(mine.numpy() - crops).max() < 1e-5
        assert np.abs(tgt.numpy() - targets).max() < 1e-6


def test_three_train_steps_match_jax(run):
    """Each of three steps from JAX's state against JAX's step in float64
    on the same inputs. The port in float64 (the standard model): the
    total, heatmap and 3D losses within 1e-10 relative (measured 6.6e-13);
    the parameters, BN statistics and RMSprop's square_avg after it within
    1e-9 of JAX's, relative to each tree's norm (1.5e-11). The port in f32
    (fused): the losses within 1e-4 relative (3.1e-5); the BN statistics
    within 5e-5 (1.3e-5), the update (new parameters minus old) within
    5e-2 (1.7e-2: the first RMSprop step moves each parameter by about 10
    learning rates times the sign of its gradient) and square_avg within
    2e-2 (6.7e-3) of JAX's, relative to each tree's norm. The step counter
    and RMSprop's count agree."""
    for s, st in enumerate(run["steps"]):
        js = st["jstate"]
        params, stats = js.params, js.batch_stats
        square = js.opt_state[0][1].square_avg
        j = np.asarray(st["jloss"])
        assert (np.abs(np.asarray(st["p64"]) - j) <= 1e-10 * np.abs(j)).all()
        assert (np.abs(np.asarray(st["p32"]) - j) <= 1e-4 * np.abs(j)).all()
        p, b, opt = st["trees64"]
        assert _rel(p, params) < 1e-9, s
        assert _rel(b, stats) < 1e-9, s
        assert _rel(opt["1"]["square_avg"], square) < 1e-9, s
        p, b, opt = st["trees32"]
        update = jax.tree.map(lambda a, c: np.asarray(a, np.float64) - c,
                              params, st["before"])
        mine = jax.tree.map(lambda a, c: np.asarray(a, np.float64) - c,
                            p, st["before"])
        assert _rel(mine, update) < 5e-2, s
        assert _rel(b, stats) < 5e-5, s
        assert _rel(opt["1"]["square_avg"], square) < 2e-2, s
        assert int(opt["1"]["count"]) == int(js.opt_state[0][1].count) \
            == s + 1
    assert run["state"].step == run["state64"].step \
        == int(run["steps"][-1]["jstate"].step) == STEPS + 1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "standard"])
def test_joint_loss_gradients_match_jax(run, h36m, fused):
    """The joint loss and its gradients, one train-mode forward (no update)
    from the JAX initial state on the first batch's inputs, against JAX's
    float64 step. The port in float64 (standard): the loss within 1e-10
    relative, each gradient leaf within 1e-8 of JAX's (measured 1.4e-10).
    The port in f32 through its fused (K3/K4 plain versions) or standard
    path: the loss within 1e-4 relative; each leaf within 2e-2 of JAX's
    float64 gradient, the median leaf within 1e-2 (measured over 187
    leaves, median (max): fused 4.3e-3 (7.1e-3), standard 2.7e-3 (6.8e-3);
    JAX's own f32 gradients sit 4.1e-1 (6.4e-1) from them)."""
    _, train = h36m
    js = run["jstate0"]
    first = run["steps"][0]
    jgrads = first["jstate"].opt_state[1]
    crops, targets = (torch.from_numpy(np.array(a))
                      for a in run["inputs"][0])
    aug = run["draws"][0]
    trainer = te.End2EndTrainer(device="cpu")
    pb = trainer.batch_tensors(run["batches"][0], train.s, train.centers,
                               train.scales)
    noise = None
    for dtype, fuse in ((torch.float64, False), (torch.float32, fused)):
        trainer = te.End2EndTrainer(variant="torch7", device="cpu",
                                    dtype=dtype,
                                    model_kw=dict(SIZE, fused=fuse))
        model = _no_dropout(trainer.make_model()).to(dtype).train()
        model.load_jax({"params": js.params, "batch_stats": js.batch_stats})
        hm, _, p3 = model(crops, pb["decode_centers"],
                          pb["decode_scales"] * aug.geometry.scale_factor,
                          *(torch.from_numpy(np.asarray(a)).to(dtype)
                            for a in (train.mean_part, train.std_part)))
        loss = te.e2e_loss(hm, p3, targets[:, trainer.remap], pb["s_norm"],
                           1.0)[0]
        loss.backward()
        conv = wt.converters_of(model)
        named = dict(model.named_parameters())
        grads = {}
        for key, path, kind in conv.param_paths(
                conv.config_of_state_dict(model.state_dict())):
            wt.put_leaf(grads, path, wt.leaf_to_jax(named[key].grad, kind))
        if noise is None:
            noise = _shift_only(model, conv)
        gaps = np.asarray(list(_leaf_gaps(grads, jgrads, noise).values()))
        assert len(gaps) > 100
        tol = 1e-10 if dtype == torch.float64 else 1e-4
        assert abs(float(loss) - first["jloss"][0]) <= tol * first["jloss"][0]
        if dtype == torch.float64:
            assert gaps.max() < 1e-8, gaps.max()
        else:
            assert gaps.max() < 2e-2 and np.median(gaps) < 1e-2, \
                (gaps.max(), np.median(gaps))


def _shift_only(model, conv):
    """The JAX paths of the biases whose shift a train-mode BN removes
    again (every conv bias of the detector but the heatmap heads', the
    lifter's Linear biases before a BN): zero gradient in exact arithmetic,
    rounding noise on both sides."""
    det = {f"hourglass.{m}.bias" for m, mod in
           model.hourglass.named_modules()
           if isinstance(mod, torch.nn.Conv2d)
           and not m.startswith("htmapArray.")}
    keys = det | {f"bilinear.{m}.0.bias" for m, mod in
                  model.bilinear.named_modules()
                  if isinstance(mod, torch.nn.Sequential)}
    return {jax.tree_util.keystr(tuple(jax.tree_util.DictKey(k)
                                       for k in path))
            for key, path, kind in conv.param_paths(
                conv.config_of_state_dict(model.state_dict()))
            if key in keys}


def _assert_trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, leaf in la:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(lb[path]),
                                      err_msg=jax.tree_util.keystr(path))


def _port_copy(run, pdir):
    state = run["trainer"].init_state(7)
    _no_dropout(state.model)
    return pckpt.resume_or_init(state, pdir)[0]


def test_port_checkpoint_resumes_in_jax(run, h36m, tmp_path):
    """The port's End2End 1.save (its state before the last step) through
    JAX resume_or_init: the same trees (both halves, RMSprop's square_avg
    of the whole tree), those of JAX's state before the last step, whose
    float64 step's loss is within 1e-4 of the port's next step from its
    own copy of the .save."""
    pdir = str(tmp_path / "parameter")
    params, stats, opt = run["resume"]["trees"]
    pckpt.save_checkpoint(pdir, 1, params, stats, opt,
                          step=run["resume"]["step"])
    js, epoch = jckpt.resume_or_init(run["jstate0"], pdir)
    assert epoch == 1 and int(js.step) == run["resume"]["step"] == STEPS
    assert set(js.params) == {"hourglass", "bilinear"}
    _assert_trees_equal(js.params, params)
    _assert_trees_equal(js.batch_stats, stats)
    _assert_trees_equal(js.opt_state[1].square_avg, opt["1"]["square_avg"])
    assert int(js.opt_state[1].count) == STEPS - 1
    _assert_trees_equal(js.params, run["resume"]["jstate"].params)
    _assert_trees_equal(js.opt_state, run["resume"]["jstate"].opt_state)
    assert run["port_next"](_port_copy(run, pdir)) == pytest.approx(
        run["jax_next"], rel=1e-4)


def test_jax_checkpoint_resumes_in_port(run, tmp_path):
    """The JAX End2End 1.save (JAX's state before the last step) through
    the port's resume: the same trees back out of TrainState.trees, and
    the next step's loss within 1e-4 of JAX's float64 step from that
    state."""
    pdir = str(tmp_path / "parameter")
    js = run["resume"]["jstate"]
    jckpt.save_checkpoint(pdir, 1, js)
    state = _port_copy(run, pdir)
    assert state.step == int(js.step) == STEPS
    assert state.optimizer.count == STEPS - 1
    params, stats, opt = state.trees()
    payload = jckpt.load_checkpoint(pdir, 1)
    _assert_trees_equal(params, payload["state"]["params"])
    _assert_trees_equal(stats, payload["state"]["batch_stats"])
    _assert_trees_equal(opt, payload["optimizer"])
    assert run["port_next"](state) == pytest.approx(run["jax_next"],
                                                    rel=1e-4)


def test_sample_augment_streams():
    """Scale jitter only, three independent streams, the same draws for the
    same (seed, epoch, step) and other draws for the next step."""
    a = te.sample_augment(0, 1, 1, 4)
    b = te.sample_augment(0, 1, 1, 4)
    c = te.sample_augment(0, 1, 2, 4)
    assert not a.geometry.flip.any() and not a.geometry.rotate_deg.any()
    assert torch.equal(a.geometry.scale_factor, b.geometry.scale_factor)
    assert torch.equal(a.jitter.brightness, b.jitter.brightness)
    assert not torch.equal(a.geometry.scale_factor, c.geometry.scale_factor)
    assert torch.equal(torch.rand(8, generator=a.dropout),
                       torch.rand(8, generator=b.dropout))
    assert a.dropout.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        te.End2EndTrainer(mesh=Mesh(data=2, model=1), device="cpu",
                          model_kw={"fused": True})


# ------------------------------------------------------------------ CLIs


def _warm_start_runs(save_root, variant="torch7"):
    """'Hourglass' (a detector of ``variant``) and 'Bilinear GT' run dirs
    with one port checkpoint each."""
    det = th.HourglassTrainer(variant=variant, device="cpu",
                              **SIZE).init_state(3)
    pckpt.save_checkpoint(os.path.join(save_root, "Hourglass", "parameter"),
                          4, *det.trees(), step=det.step)
    lift = te.End2EndTrainer(device="cpu", model_kw=SIZE).make_model(
        4).bilinear
    pckpt.save_checkpoint(os.path.join(save_root, "Bilinear GT",
                                       "parameter"), 2,
                          *wt.bilinear_to_jax(lift.state_dict()))
    return det.model, lift


def test_cli_train_then_valid_on_the_cpu(h36m, tmp_path):
    """train_end2end at the small size: warm-starts both halves, resumes,
    writes 2.save with the steps of two epochs, and passes the size flags
    and --fused-blocks to the model; valid_end2end writes a finite
    mpjpe_e2e_epoch2.json, and stops on a run with no checkpoint; a
    warm-start detector of the other variant stops with both names. Each
    CLI turns cuDNN's TF32 off."""
    root, train = h36m
    save_root = str(tmp_path / "save")
    det, lift = _warm_start_runs(save_root)
    argv = ["--data-dir", root, "--save-root", save_root, "--variant",
            "torch7", "--fused-blocks", "true", "--batch-size", str(BATCH),
            "--canvas", str(CANVAS), "--n-stacks", "2", "--features", "16",
            "--depth", "2", "--learning-rate", "2.5e-5", "--device", "cpu",
            "--epochs-per-run", "1"]
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    train_end2end.main(argv)
    assert not torch.backends.cudnn.allow_tf32
    pdir = os.path.join(save_root, "End2End", "parameter")
    first = pckpt.load_checkpoint(pdir, 1)
    warm = wt.hourglass_torch7_to_jax(det.state_dict())[0]
    # One step of 2.5e-5 from the warm start: near it, not at a fresh init.
    a, b = (_flat(t) for t in (first["state"]["params"]["hourglass"], warm))
    assert np.abs(a - b).max() < 5 * 2.5e-5 * 10 * (len(train.s) // BATCH)
    train_end2end.main(argv)
    with open(os.path.join(save_root, "End2End", "debug.log")) as f:
        text = f.read()
    assert "Warm-started hourglass" in text
    assert "Warm-started bilinear" in text
    steps = len(train.s) // BATCH
    assert f"Resumed from epoch 1 (step {steps + 1})" in text
    payload = pckpt.load_checkpoint(pdir, 2)
    assert payload["step"] == 2 * steps + 1
    assert int(payload["optimizer"]["1"]["count"]) == 2 * steps
    valid = ["--data-dir", root, "--save-root", save_root, "--variant",
             "torch7", "--batch-size", str(BATCH), "--canvas", str(CANVAS),
             "--n-stacks", "2", "--features", "16", "--depth", "2",
             "--device", "cpu"]
    torch.backends.cudnn.allow_tf32 = True
    valid_end2end.main(valid)
    assert not torch.backends.cudnn.allow_tf32

    with open(os.path.join(save_root, "End2End",
                           "mpjpe_e2e_epoch2.json")) as f:
        out = json.load(f)
    assert out["epoch"] == 2 and np.isfinite(out["overall"])
    with pytest.raises(SystemExit, match="no checkpoint under"):
        valid_end2end.main(valid + ["--comment", "empty"])

    other = str(tmp_path / "other")
    _warm_start_runs(other, variant="preact")
    with pytest.raises(SystemExit, match="'preact' detector.*'torch7'"):
        train_end2end.main(argv[:3] + [other] + argv[4:])


def test_clis_raise_without_a_card(h36m, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root, _ = h36m
    for main in (train_end2end.main, valid_end2end.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--data-dir", root, "--save-root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        webcam.main(["--synthetic", "--frames", "1", "--save-root",
                     str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.End2EndTrainer()
