"""Lifting training in the port (bilinear_tpu_torch: core/optim, the
train-mode BilinearUnit, train/bilinear, the Adam state in checkpoints,
cli/train_bilinear and cli/valid_bilinear) against the JAX package on the
CPU. Inputs come from numpy with seed 0; f32 unless a test says otherwise.
Training parity runs with dropout 0: the two packages' RNGs differ.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bilinear_tpu.core import optim as jopt
from bilinear_tpu.data import h36m as jh36m
from bilinear_tpu.eval.mpjpe import evaluate_mpjpe as jax_evaluate_mpjpe
from bilinear_tpu.io import checkpoint as jckpt
from bilinear_tpu.models.bilinear import BilinearUnit as JaxBilinearUnit
from bilinear_tpu.train.bilinear import BilinearTrainer as JaxTrainer
from bilinear_tpu_torch.cli import train_bilinear, valid_bilinear
from bilinear_tpu_torch.config import BilinearConfig, parse_config
from bilinear_tpu_torch.core.optim import bilinear_optimizer, \
    reference_bilinear_schedule
from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
from bilinear_tpu_torch.io import checkpoint as pckpt
from bilinear_tpu_torch.models.bilinear import BilinearUnit
from bilinear_tpu_torch.train.bilinear import BilinearTrainer, \
    epoch_permutation
from bilinear_tpu_torch.utils import weights as wt

BATCHES = (64,) * 7 + (13,)  # eight steps, the last a tail step


def _assert_trees_close(a, b, rtol=0.0, atol=0.0, what=""):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, leaf in la:
        np.testing.assert_allclose(
            np.asarray(leaf, np.float64), np.asarray(lb[path], np.float64),
            rtol=rtol, atol=atol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


# ------------------------------------------------------------ optimizer

COUNTS = list(range(13)) + [99_999, 100_000, 100_001, 199_999, 200_000,
                            200_001]


@pytest.mark.parametrize("period", [5, 100_000])
def test_schedule_matches_jax(period):
    ours = reference_bilinear_schedule(period=period)
    theirs = jopt.reference_bilinear_schedule(period=period)
    for count in COUNTS:
        assert ours(count) == float(theirs(jnp.asarray(count, jnp.int32))), \
            count


def test_optimizer_matches_jax():
    """12 updates of clip + Adam with the schedule at period 5 (three rate
    re-sets), gradients that are clipped on odd steps only. Parameters
    start at zero, so each step's change is the update itself: within 1e-5
    relative (atol 1e-6 of the leaf's largest update, for elements whose
    first moment nearly cancels). Not 1e-6: JAX takes the bias correction
    1 - b2^t in f32, where b2 = 0.999 rounds to 0.99900001287, so its
    v / (1 - b2^t) is 1.29e-5 high at early steps and its update 6.4e-6 low
    (measured 6.9e-6 at step 1); torch takes the corrections in float64, as
    the reference does. The moments themselves agree to 1e-6."""
    rng = np.random.RandomState(0)
    shapes = {"w": (32, 16), "b": (16,), "v": (16, 48)}
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    tx = jopt.bilinear_optimizer(jopt.reference_bilinear_schedule(period=5))
    jstate = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in
               shapes.items()}
    opt = bilinear_optimizer(list(tparams.values()),
                             reference_bilinear_schedule(period=5))
    for step in range(12):
        scale = 0.1 if step % 2 else 0.01  # global norm ~3.6 / ~0.36
        grads = {k: (rng.randn(*s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = tx.update(grads, jstate, params)
        params = optax.apply_updates(params, upd)
        before = {k: p.detach().clone() for k, p in tparams.items()}
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, p in tparams.items():
            ours = (p.detach() - before[k]).numpy()
            theirs = np.asarray(upd[k])
            np.testing.assert_allclose(
                ours, theirs, rtol=1e-5,
                atol=1e-6 * float(np.abs(theirs).max()),
                err_msg=f"step {step + 1} {k}")
    adam = jstate[1]
    assert opt.count == int(adam.count) == 12
    for k, p in tparams.items():  # torch's lerp rounds apart, ~1e-9
        for ours, theirs in zip(opt.moments(p), (adam.mu[k], adam.nu[k])):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(
                ours.numpy(), theirs, rtol=1e-6,
                atol=1e-6 * float(np.abs(theirs).max()))


def test_opt_state_round_trip_is_exact():
    rng = np.random.RandomState(0)
    model = BilinearUnit(generator=torch.Generator().manual_seed(0))
    named = dict(model.named_parameters())
    mu = {k: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
          for k, p in named.items()}
    nu = {k: torch.from_numpy(rng.rand(*p.shape).astype(np.float32))
          for k, p in named.items()}
    tree = wt.bilinear_opt_to_jax(7, mu, nu)
    assert tree["0"] == {} and tree["1"]["count"].dtype == np.int32
    assert jax.tree.structure(tree["1"]["mu"]) == jax.tree.structure(
        wt.bilinear_to_jax(model.state_dict())[0])
    count, mu2, nu2 = wt.bilinear_opt_from_jax(tree)
    assert count == 7 and mu2.keys() == mu.keys()
    for k in mu:
        assert torch.equal(mu[k], mu2[k]) and torch.equal(nu[k], nu2[k])


# ---------------------------------------------------------- train steps


@pytest.fixture(scope="module")
def jax_side():
    """The JAX trainer (dropout 0) at full width, its jitted step, its
    initial state and the eight steps' batches."""
    trainer = JaxTrainer(dropout=0.0)
    state = trainer.init_state(jax.random.PRNGKey(0))
    step = jax.jit(trainer._train_step)
    rng = np.random.RandomState(0)
    batches = [(rng.randn(b, 32).astype(np.float32),
                rng.randn(b, 48).astype(np.float32)) for b in BATCHES]
    return trainer, step, state, batches


def _port_state(jstate, **kw):
    """A port TrainState holding the JAX state's weights and statistics."""
    state = BilinearTrainer(dropout=0.0, device="cpu", **kw).init_state(5)
    state.model.load_state_dict(wt.bilinear_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats)))
    return state


@pytest.fixture(scope="module")
def eight_steps(jax_side):
    """Both packages through the eight steps from one state; the states
    after step 4 as well."""
    _, jstep, jstate, batches = jax_side
    trainer = BilinearTrainer(dropout=0.0, device="cpu")
    state = _port_state(jstate)
    losses, jlosses, at4 = [], [], None
    for i, (bx, by) in enumerate(batches):
        losses.append(float(trainer.train_step(
            state, torch.from_numpy(bx), torch.from_numpy(by), None)))
        jstate, jl = jstep(jstate, bx, by, jax.random.PRNGKey(1))
        jlosses.append(float(jl))
        if i == 3:
            at4 = (state.trees(), jax.tree.map(np.asarray, jstate))
    return state, jstate, losses, jlosses, at4


# A Linear followed by a train-mode BN: its bias only shifts what the BN
# subtracts again, so its gradient is zero in exact arithmetic and rounding
# noise on both sides (|mu| ~ 1e-11), which Adam rescales to moves of order
# lr in either direction.
SHIFT_ONLY = ("['linear']['bias']",)


def test_train_steps_match_jax(eight_steps):
    """Eight steps at full width from one state. Losses within 1e-4
    relative over the first six steps. After step 4: parameters within
    2e-4 absolute (a fifth of one step's largest move at lr 1e-3), BN
    running statistics within 1e-4 (relative and absolute), Adam's mu and
    nu within 1e-4 of the leaf's largest value, the shift-only biases'
    moments excepted (noise on both sides). Then the trajectories part:
    where Adam's first steps rescale a gradient near rounding noise to a
    move of order lr, the moves grow over the steps (ROADMAP Queue 3 has
    the measured gaps); so the last two losses are held to 1e-3 (measured
    6.0e-5 and 2.5e-4, the second at the 13-row tail step) and the
    parameters after step 8 to 2e-4 for 99.9% of them and 2e-3 for all
    (measured 0.07% over 2e-4, max 1.5e-3)."""
    state, jstate, losses, jlosses, at4 = eight_steps
    np.testing.assert_allclose(losses[:6], jlosses[:6], rtol=1e-4)
    np.testing.assert_allclose(losses[6:], jlosses[6:], rtol=1e-3)

    (params, stats, opt), j4 = at4
    _assert_trees_close(params, j4.params, atol=2e-4, what="params@4")
    for name in j4.batch_stats:
        mine, theirs = stats[name]["bn"], j4.batch_stats[name]["bn"]
        assert int(mine["count"]) == int(theirs["count"]) == 4
        for k in ("mean", "var"):
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} {k}")
    adam = j4.opt_state[1]
    assert int(opt["1"]["count"]) == int(adam.count) == 4
    for ours, theirs in ((opt["1"]["mu"], adam.mu), (opt["1"]["nu"], adam.nu)):
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ours),
                                jax.tree.leaves(theirs)):
            if jax.tree_util.keystr(path).endswith(SHIFT_ONLY):
                continue
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * float(np.abs(b).max()),
                                       err_msg=jax.tree_util.keystr(path))

    assert state.step == int(jstate.step) == 9
    assert state.optimizer.count == int(jstate.opt_state[1].count) == 8
    params, jparams = state.trees()[0], jax.tree.map(np.asarray,
                                                     jstate.params)
    _assert_trees_close(params, jparams, atol=2e-3, what="params@8")
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(jparams))])
    assert (d > 2e-4).mean() < 1e-3


def test_epoch_structure():
    """n = 5 * 64 + 13: six steps, the last of 13 rows; every row once, in
    the epoch's permutation; step and Adam count advance by 6. With dropout
    0.5 the masks come from the trainer's generator: the same seed gives
    the same losses, another seed others."""
    n = 5 * 64 + 13
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(n, 32).astype(np.float32))
    y = torch.from_numpy(rng.randn(n, 48).astype(np.float32))
    seen = []

    class Recording(BilinearTrainer):
        def train_step(self, state, bx, by, gen):
            seen.append(bx.clone())
            return super().train_step(state, bx, by, gen)

    trainer = Recording(device="cpu")
    state = trainer.init_state(0)
    losses = trainer.train_epoch(state, x, y, epoch=3, seed=1)
    assert losses.shape == (6,) and bool(torch.isfinite(losses).all())
    assert [len(b) for b in seen] == [64] * 5 + [13]
    perm = epoch_permutation(1, 3, n)
    assert sorted(perm.tolist()) == list(range(n))
    assert torch.equal(torch.cat(seen), x[perm])
    assert state.step == 7 and state.optimizer.count == 6

    again = BilinearTrainer(device="cpu").init_state(0)
    other = BilinearTrainer(device="cpu").init_state(0)
    same = BilinearTrainer(device="cpu").train_epoch(again, x, y, 3, seed=1)
    diff = BilinearTrainer(device="cpu").train_epoch(other, x, y, 3, seed=2)
    assert torch.equal(same, losses)
    assert not torch.equal(diff, losses)


def test_dropout_mask_comes_from_the_generator():
    """Inverted dropout with p = 0.5: about half the activations zero, the
    rest doubled; the mask is the generator's (same seed, same output) and
    train mode without a generator raises."""
    model = BilinearUnit(generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.RandomState(0).randn(256, 32)
                         .astype(np.float32))
    outs = [model.encode(x, torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    model.eval()
    ref = model.encode(x)
    kept = outs[0] != 0
    assert 0.4 < float(kept[ref != 0].float().mean()) < 0.6
    model.train()
    with pytest.raises(ValueError, match="explicit"):
        model(x)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_forward_matches_jax(train):
    """The bf16 compute type (bf16 Linears, f32 BN, f32 output) against
    flax's BilinearUnit(dtype=bfloat16), dropout 0. A value at a bf16
    rounding boundary rounds one step apart on one side and carries: mean
    |d| < 2e-3 and max |d| < 0.1, relative to mean |ref|."""
    from torch_port_fixtures import rows, scrambled_variables

    params, stats = scrambled_variables(0)
    x = rows(256, 3)
    model = BilinearUnit(dropout=0.0, dtype=torch.bfloat16)
    model.load_state_dict(wt.bilinear_from_jax(params, stats))
    model.train(train)
    jmodel = JaxBilinearUnit(dtype=jnp.bfloat16, dropout=0.0)
    ref = jmodel.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), train=train, mutable=["batch_stats"])
    ref = np.asarray(ref[0])
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and ref.dtype == np.float32
    d, scale = np.abs(out - ref), np.abs(ref).mean()
    assert d.mean() < 2e-3 * scale and d.max() < 0.1 * scale


# ---------------------------------------------------------- checkpoints


def test_jax_checkpoint_resumes_in_port(tmp_path, jax_side):
    """A JAX-written 1.save after two steps, resumed by the port: the next
    step's loss as the JAX package continuing (1e-4 relative), and the
    parameters after it within 2e-4."""
    _, jstep, jstate, batches = jax_side
    for bx, by in batches[:2]:
        jstate, _ = jstep(jstate, bx, by, jax.random.PRNGKey(1))
    pdir = str(tmp_path / "parameter")
    jckpt.save_checkpoint(pdir, 1, jstate)
    trainer = BilinearTrainer(dropout=0.0, device="cpu")
    state, epoch = pckpt.resume_or_init(trainer.init_state(9), pdir)
    assert epoch == 1 and state.step == 3 and state.optimizer.count == 2
    bx, by = batches[2]
    loss = float(trainer.train_step(state, torch.from_numpy(bx),
                                    torch.from_numpy(by), None))
    jstate, jloss = jstep(jstate, bx, by, jax.random.PRNGKey(1))
    assert loss == pytest.approx(float(jloss), rel=1e-4)
    _assert_trees_close(state.trees()[0],
                        jax.tree.map(np.asarray, jstate.params), atol=2e-4)


def test_port_checkpoint_restores_in_jax(tmp_path, eight_steps, jax_side):
    """A port-written .save through the JAX package's restore_state:
    parameters, statistics and Adam state equal, bit for bit."""
    state = eight_steps[0]
    trainer = jax_side[0]
    pdir = str(tmp_path / "parameter")
    params, stats, opt = state.trees()
    pckpt.save_checkpoint(pdir, 4, params, stats, opt, step=state.step)
    template = trainer.init_state(jax.random.PRNGKey(3))
    restored, epoch = jckpt.resume_or_init(template, pdir)
    assert epoch == 4 and int(restored.step) == state.step
    _assert_trees_close(restored.params, params)
    _assert_trees_close(restored.batch_stats, stats)
    adam = restored.opt_state[1]
    assert int(adam.count) == state.optimizer.count == 8
    _assert_trees_close(adam.mu, opt["1"]["mu"])
    _assert_trees_close(adam.nu, opt["1"]["nu"])


# ------------------------------------------------------------------ CLIs


def test_config_mirrors_jax():
    cfg = parse_config(BilinearConfig(), ["--batch-size", "32", "--dtype",
                                          "bfloat16", "--lr-decay", "x"])
    assert cfg.batch_size == 32 and cfg.dtype == "bfloat16"
    assert cfg.lr_decay.period == 100_000 and cfg.protocol == "GT"


@pytest.mark.parametrize("flag,error", [
    # --coordinator, --profile and --debug-nans are ported; a
    # tensor-parallel run without a process group is what the CLI refuses.
    (["--model-parallel", "2"], ValueError)],
    ids=["coordinator"])
def test_train_cli_refuses_what_is_not_ported(flag, error):
    with pytest.raises(error):
        train_bilinear.main(flag + ["--device", "cpu"])


@pytest.mark.parametrize("cli", [train_bilinear, valid_bilinear],
                         ids=["train_bilinear", "valid_bilinear"])
def test_cli_without_a_card_raises(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--data-dir", str(tmp_path), "--save-root",
                  str(tmp_path / "save")])


def test_cli_trains_resumes_and_validates(tmp_path):
    """train_bilinear for 2 epochs, then 1 more that resumes from 2.save;
    then valid_bilinear, whose overall MPJPE is within 1e-4 relative of the
    JAX package's evaluate_mpjpe on the same checkpoint."""
    data = str(tmp_path / "h36m")
    write_h36m_dataset(data, n_train=333, n_valid=100)
    argv = ["--data-dir", data, "--save-root", str(tmp_path / "save"),
            "--comment", "bi", "--device", "cpu"]
    train_bilinear.main(argv + ["--epochs-per-run", "2"])
    train_bilinear.main(argv + ["--epochs-per-run", "1"])
    run = tmp_path / "save" / "bi"
    pdir = str(run / "parameter")
    assert sorted(os.listdir(pdir)) == ["1.save", "2.save", "3.save"]
    log = (run / "debug.log").read_text()
    assert "Resumed from epoch 2 (step 13)" in log
    assert "1 epochs in" in log and "poses/sec" in log
    payload = pckpt.load_checkpoint(pdir, 3)
    assert payload["step"] == 19
    assert int(payload["optimizer"]["1"]["count"]) == 18

    valid_bilinear.main(argv)
    import json

    with open(run / "mpjpe_epoch3.json") as f:
        result = json.load(f)
    jvalid = jh36m.load_h36m(data, jh36m.Protocol.GT)[jh36m.Task.Valid]
    variables = {"params": payload["state"]["params"],
                 "batch_stats": payload["state"]["batch_stats"]}
    per_action, overall = jax_evaluate_mpjpe(JaxBilinearUnit(), variables,
                                             jvalid)
    assert result["epoch"] == 3
    assert result["overall"] == pytest.approx(overall, rel=1e-4)
    for k, v in per_action.items():
        assert result["per_action"][k] == pytest.approx(v, rel=1e-4)
