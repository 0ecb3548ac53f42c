"""Rematerialisation of the port's detector trainer
(``HourglassTrainer(remat=True)``, ``core/remat.py``) on the CPU: the stem
and every stack recomputed in the backward.

- Against a plain step of the port, from one state on one batch: the loss,
  every gradient and every BN buffer (running statistics and
  ``num_batches_tracked``: updated once, not again by the recomputation)
  bit for bit, for the torch7 detector with fused blocks (K3/K4's plain
  versions) and without, and for the pre-activation detector; the fused
  blocks run twice per step (forward and recomputation).
- Against JAX's remat step (``HourglassTrainer(remat=True)._train_step``,
  which wraps its forward in ``jax.checkpoint``), torch7 fused and
  standard. JAX's step is given the port's crops and targets (its
  ``preprocess_batch`` replaced: the preprocessing is held to JAX
  elsewhere, and JAX's jitted jitter differs from its eager one, ROADMAP.md
  Queue 3), so the two steps differ by the model's arithmetic alone: the
  loss rel 1e-5 (``test_gradients_match_jax``'s gate), and after the step
  the parameters, BN statistics and RMSprop's square_avg by the torch7
  optimizer-step test's gates (``_close_trees``: max |diff| below 0.02,
  cosine above 0.999).

Tiny model: 2 stacks, 16 features, depth 2; batch 2 of 128-px canvases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.core.state import TrainState as JaxTrainState
from bilinear_tpu.train import hourglass as jhourglass
from bilinear_tpu.train.hourglass import HourglassTrainer as JaxTrainer
from bilinear_tpu_torch.ops import resmodule as rk
from bilinear_tpu_torch.train import hourglass as th
from bilinear_tpu_torch.utils import weights as wt
from test_torch_port_ft_train import _close_trees
from torch_port_fixtures import one_torch_thread  # noqa: F401

SIZE = dict(n_stacks=2, features=16, depth=2)
B = 2


def _batch():
    rng = np.random.RandomState(3)
    return {
        "images": rng.rand(B, 128, 128, 3).astype(np.float32),
        "centers": np.full((B, 2), 64.0, np.float32),
        "scales": np.full((B,), 0.5, np.float32),
        "keypoints": rng.uniform(30, 100, (B, 16, 2)).astype(np.float32),
        "valid": np.ones((B, 16), bool),
    }


def _draws():
    return th.sample_augment(th.step_generator(0, 1, 1), B)


def _port_step(variant, fused, remat):
    trainer = th.HourglassTrainer(variant=variant, fused_blocks=fused,
                                  remat=remat, device="cpu", **SIZE)
    state = trainer.init_state(0)
    draws = _draws()
    loss = trainer.train_step(
        state, {k: torch.from_numpy(v) for k, v in _batch().items()}, draws)
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters()
             if p.grad is not None}
    return float(loss), grads, {k: v.clone() for k, v in
                                state.model.state_dict().items()}, state


@pytest.mark.parametrize("variant, fused", [("torch7", True),
                                            ("torch7", False),
                                            ("preact", False)])
def test_remat_step_is_the_plain_step(variant, fused, monkeypatch):
    calls = [0]
    ref = rk.res_block_ref

    def counted(*a, **k):
        calls[0] += 1
        return ref(*a, **k)

    monkeypatch.setattr(rk, "res_block_ref", counted)
    loss, grads, sd, _ = _port_step(variant, fused, remat=False)
    plain_calls = calls[0]
    calls[0] = 0
    rloss, rgrads, rsd, _ = _port_step(variant, fused, remat=True)
    assert rloss == loss
    assert set(rgrads) == set(grads)
    for k in grads:
        assert torch.equal(rgrads[k], grads[k]), k
    for k in sd:
        assert torch.equal(rsd[k], sd[k]), k
    n_blocks = 3 + 2 * (3 * 2 + 1)  # the stem's and each stack's ResModules
    assert plain_calls == (n_blocks if fused else 0)
    assert calls[0] == 2 * plain_calls  # the recomputation runs them again


@pytest.mark.parametrize("fused", [True, False])
def test_remat_step_matches_jax_remat(fused):
    loss, _, _, state = _port_step("torch7", fused, remat=True)
    jtrainer = JaxTrainer(variant="torch7", remat=True, fused_blocks=fused,
                          **SIZE)
    model = th.make_model("torch7", generator=torch.Generator()
                          .manual_seed(0), **SIZE)
    jstate = JaxTrainState.create(*wt.hourglass_torch7_to_jax(
        model.state_dict()), jtrainer.tx)
    d = {k: torch.from_numpy(v) for k, v in _batch().items()}
    crops, targets, kp = th.preprocess_batch(
        d["images"], d["centers"], d["scales"], d["keypoints"], d["valid"],
        _draws())
    port_pre = tuple(jnp.asarray(t.numpy()) for t in (crops, targets, kp))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhourglass, "preprocess_batch", lambda *a, **k: port_pre)
        jstate, jloss = jax.jit(jtrainer._train_step)(
            jstate, {k: jnp.asarray(v) for k, v in _batch().items()},
            jax.random.PRNGKey(1))
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    params, stats, opt = state.trees()
    _close_trees(params, jstate.params, "params")
    _close_trees(stats, jstate.batch_stats, "batch_stats")
    _close_trees(opt["1"]["square_avg"], jstate.opt_state[1].square_avg,
                 "square_avg")
