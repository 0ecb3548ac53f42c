"""The port's data and tensor parallelism (bilinear_tpu_torch/parallel/
mesh.py, parallel/tp.py, the trainers' ``mesh=``, the training CLIs'
``--coordinator``) and its local-device mesh servers, against the JAX
package and against the port in one process, on the CPU.

Multi-process runs are gloo groups of CPU processes
(tests/torch_port_dist_worker.py, torch only); the JAX side is computed
here while they run. Tolerances:

- a DP or DP x TP step against JAX's single-device ``_train_step`` (the
  JAX TP step is held to it too): losses and parameter digests rel 2e-4,
  as JAX's tests/test_distributed.py holds its two-process runs (the
  reduction order crosses processes);
- DP against the port in one process, where the order of the sums is the
  only difference: losses rel 1e-5; Adam's moments (so the clipped
  gradients) within 1e-4 of each leaf's largest value and BN statistics
  within 1e-5; parameters within 1e-5 of the leaf's largest value plus
  0.1 lr (Adam's first step moves an element whose gradient is near eps
  by up to lr, so rounding noise there moves the parameter: 2.1e-5 seen
  at lr 1e-3);
- the hourglass step (2 stacks, 16 features, depth 2, a seeded port
  initialisation, batch 8 of 128-px f32 canvases, flips drawn) against
  the port in one process: in f32 loss rel 1e-5 and BN statistics within
  1e-5 of each leaf's largest value (the f32 gradients of this randomly
  initialised net are ill-conditioned, ROADMAP.md Queue 3: the stem
  conv's sat 5e-3 of its largest value apart); computed in float64 (the
  parameters and gradients f32), loss rel 1e-12, gradients and BN
  statistics within 1e-6 of each leaf's largest value (a few f32 ulps),
  and the parameters after RMSprop's first step, which amplifies
  gradients near eps, where |g| > 3e-5 at rtol 2e-3, atol 2e-4 (JAX's
  amplified gate, tests/test_parallel_pp.py);
  against JAX's step loss (its preprocessing with the same draws, run
  eagerly, then its model), loss rel 2e-4 (JAX's two-process gate;
  measured 2.6e-5): JAX's jitted step sits 2.5e-3 from its own eager
  one here, its jitted colour jitter rotating the channels of 1.6% of the
  pixels (ROADMAP.md Queue 3);
- an End2End step (that detector and the full-width lifter at dropout
  0.5), the whole model in float64, against the port in one process:
  losses rel 1e-12, gradients within 1e-9 and BN statistics within 1e-10
  of each leaf's largest value;
- the same hourglass and End2End steps with fused blocks (K3/K4's plain
  versions, their BN reductions merged over the data group), the whole
  model in float64, on the batch's first 3 rows (the detector, split
  1 / 2) and 4 rows (End2End, split 2 / 2), at those gates, and the fused hourglass step on its first row alone (rank 0
  holds none); the fused hourglass step's loss also rel 2e-4 of JAX's
  single-device fused model on JAX's crops;
- the sharded servers: every block's rows are the unsharded server's on
  that block bit for bit (the same kernels on the same rows), and within
  1e-5 relative of the whole batch's.
"""
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.models.hourglass_torch7 import MainModel as JaxMainModel
from bilinear_tpu.ops import augment as jaug
from bilinear_tpu.parallel import mesh as jmesh
from bilinear_tpu.parallel.tp import shard_train_state
from bilinear_tpu.train.bilinear import BilinearTrainer as JaxBilinear
from bilinear_tpu.train import hourglass as jhourglass
from bilinear_tpu_torch.cli import train_bilinear
from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
from bilinear_tpu_torch.io import checkpoint as pckpt
from bilinear_tpu_torch.ops import augment as aug
from bilinear_tpu_torch.parallel import mesh as pmesh
from bilinear_tpu_torch.serving import End2EndServer, LiftingServer
from bilinear_tpu_torch.train import hourglass as th
from bilinear_tpu_torch.train.bilinear import BilinearTrainer
from bilinear_tpu_torch.train.end2end import E2EAugment
from bilinear_tpu_torch.utils import weights as wt
from test_torch_port_ft_train import _FixedDraws, _jax_args
from torch_port_fixtures import one_torch_thread  # noqa: F401
from torch_port_fixtures import rows, scrambled_variables
import torch_port_dist_worker as dw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_dist_worker.py")
HG_SIZE = dict(n_stacks=2, features=16, depth=2)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(argv_of, world):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return [subprocess.Popen(argv_of(r), cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(world)]


def _wait(procs):
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (out[-2000:], err[-4000:])


def _hg_data():
    rng = np.random.RandomState(0)
    b = 8
    return {
        "images": rng.rand(b, 128, 128, 3).astype(np.float32),
        "centers": np.full((b, 2), 64.0, np.float32),
        "scales": np.full((b,), 0.5, np.float32),
        "keypoints": rng.uniform(30, 100, (b, 16, 2)).astype(np.float32),
        "valid": np.ones((b, 16), bool),
    }


def _e2e_data():
    """The detector's batch (f32 canvases) and the lifter's float64 rows."""
    rng = np.random.RandomState(1)
    return dict(_hg_data(), s_norm=rng.randn(8, 48),
                decode_centers=np.full((8, 2), 64.0),
                decode_scales=np.full((8,), 0.5))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the worker groups and the two-process CLI run, computes the
    JAX side meanwhile, and returns everything."""
    work = str(tmp_path_factory.mktemp("dist"))
    rng = np.random.RandomState(0)
    jt = JaxBilinear(batch_size=16, learning_rate=1e-3, dropout=0.0)
    jstate = jax.device_get(jt.init_state(jax.random.PRNGKey(0)))
    hg_model = th.make_model("torch7", generator=torch.Generator()
                             .manual_seed(0), **HG_SIZE)
    hg_params, hg_stats = wt.hourglass_torch7_to_jax(hg_model.state_dict())
    draws = th.sample_augment(th.step_generator(0, 1, 1), 8)
    inputs = dict(
        bilinear_payload=dict(step=1, optimizer={}, state=dict(
            params=jstate.params, batch_stats=jstate.batch_stats)),
        hourglass_payload=dict(step=1, optimizer={"0": {}, "1": dict(
            count=np.asarray(0, np.int32),
            square_avg=jax.tree.map(np.zeros_like, hg_params))},
            state=dict(params=hg_params, batch_stats=hg_stats)),
        bx=rng.randn(16, 32).astype(np.float32),
        by=rng.randn(16, 48).astype(np.float32),
        ex=rng.randn(29, 32).astype(np.float32),
        ey=rng.randn(29, 48).astype(np.float32),
        hg_batch=_hg_data(), hg_draws=draws, e2e_batch=_e2e_data(),
        e2e_stats=(rng.randn(32), rng.rand(32) + 0.5))
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)

    groups = {}
    for scenario, world in (("dp", 2), ("tp", 4)):
        port = _free_port()
        groups[scenario] = _spawn(
            lambda r, s=scenario, w=world, p=port: [
                sys.executable, WORKER, s, str(r), str(w), str(p), work],
            world)

    # The CLI: two ranks for one epoch, then one process resumes.
    h36m = str(tmp_path_factory.mktemp("h36m"))
    write_h36m_dataset(h36m, n_train=40, n_valid=8)
    cli_args = ["--data-dir", h36m, "--batch-size", "16", "--device", "cpu",
                "--epochs-per-run", "1", "--comment", "dp"]
    dp_root = os.path.join(work, "cli_dp")
    port = _free_port()
    groups["cli"] = _spawn(lambda r: [
        sys.executable, "-m", "bilinear_tpu_torch.cli.train_bilinear",
        *cli_args, "--save-root", dp_root, "--coordinator",
        f"localhost:{port}", "--num-processes", "2", "--process-id", str(r)],
        2)

    # The JAX side.
    bx, by = jnp.asarray(inputs["bx"]), jnp.asarray(inputs["by"])
    sref, lref = jax.jit(jt._train_step)(jstate, bx, by,
                                         jax.random.PRNGKey(1))
    tmesh = jmesh.make_mesh(jax.devices()[:4], data=2, model=2)
    tt = JaxBilinear(batch_size=16, learning_rate=1e-3, dropout=0.0,
                     mesh=tmesh)
    stp, ltp = jax.jit(tt._train_step)(
        shard_train_state(jt.init_state(jax.random.PRNGKey(0)), tmesh),
        jax.device_put(bx, jmesh.batch_sharding(tmesh, 2)),
        jax.device_put(by, jmesh.batch_sharding(tmesh, 2)),
        jax.random.PRNGKey(1))

    # JAX's step loss: its preprocessing with the same draws, eager (its
    # jitted colour jitter rotates the channels of 1.6% of these pixels
    # against its own eager one: ROADMAP.md Queue 3), then its model.
    fixed = _FixedDraws()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaug, "sample_geometry", fixed.geometry)
        mp.setattr(jaug, "color_jitter_batch", fixed.jitter)
        fixed.geo, fixed.jit = _jax_args(draws)
        hg = _hg_data()
        crops, targets, _ = jhourglass.preprocess_batch(
            jax.random.PRNGKey(2), *(jnp.asarray(hg[k]) for k in (
                "images", "centers", "scales", "keypoints", "valid")),
            augment=True)
    def jax_loss(jmodel, n=8):
        @jax.jit
        def loss(crops, targets):
            out, _ = jmodel.apply({"params": hg_params,
                                   "batch_stats": hg_stats},
                                  crops, train=True, mutable=["batch_stats"])
            tgt = jnp.transpose(targets, (0, 2, 3, 1))
            return jnp.sum(jnp.mean(jnp.square(out - tgt[None]),
                                    axis=(1, 2, 3, 4)))
        return float(loss(crops[:n], targets[:n]))

    hloss = jax_loss(JaxMainModel(**HG_SIZE))
    hloss_fused = jax_loss(JaxMainModel(**HG_SIZE, fused=True), dw.FUSED_ROWS)

    # The port in one process, on the same inputs.
    one = {}
    for name, dropout in (("step0", 0.0), ("step5", 0.5)):
        t = BilinearTrainer(batch_size=16, learning_rate=1e-3,
                            dropout=dropout, device="cpu")
        st = t.init_state(0)
        st.restore(inputs["bilinear_payload"])
        loss = t.train_step(st, torch.from_numpy(inputs["bx"]),
                            torch.from_numpy(inputs["by"]),
                            t.dropout_generator(3, 1))
        one[name] = dict(loss=float(loss), trees=st.trees())
    t = BilinearTrainer(batch_size=16, learning_rate=1e-3, dropout=0.5,
                        device="cpu")
    st = t.init_state(0)
    st.restore(inputs["bilinear_payload"])
    losses = t.train_epoch(st, torch.from_numpy(inputs["ex"]),
                           torch.from_numpy(inputs["ey"]), epoch=1, seed=3)
    one["epoch"] = dict(losses=losses.numpy(), trees=st.trees())
    for name, dtype, fused, n in (
            ("hourglass", torch.float32, False, 8),
            ("hourglass64", torch.float64, False, 8),
            ("hourglass_fused", torch.float64, True, dw.FUSED_ROWS),
            ("hourglass_fused_one_row", torch.float64, True, 1)):
        one[name] = dw.hourglass_step(None, inputs, dtype, fused, n)
    one["end2end"] = dw.end2end_step(None, inputs)
    one["end2end_fused"] = dw.end2end_step(None, inputs, True,
                                           dw.E2E_FUSED_ROWS)

    cli_one = os.path.join(work, "cli_one")
    train_bilinear.main(cli_args + ["--save-root", cli_one])

    for procs in groups.values():
        _wait(procs)
    out = {}
    for scenario, world in (("dp", 2), ("tp", 4)):
        out[scenario] = []
        for r in range(world):
            with open(os.path.join(work, f"{scenario}_{r}.pkl"), "rb") as f:
                out[scenario].append(pickle.load(f))
    return dict(out=out, one=one, jax=dict(
        step=(jax.device_get(sref), float(lref)),
        tp=(jax.device_get(stp), float(ltp)),
        hourglass=hloss, hourglass_fused=hloss_fused),
        dp_root=dp_root, cli_one=cli_one, cli_args=cli_args)


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(v, np.float64))
                           for v in jax.tree.leaves(tree)])


def _digest(params):
    return float(np.abs(np.asarray(
        params["encode"]["linear"]["kernel"])).sum())


def _leafwise(got, want, tol, what, atol=0.0):
    """Each leaf within ``tol`` of its largest value plus ``atol``. A
    moment leaf below 1e-8 is rounding noise on both sides (the Linear
    bias in front of a train-mode BN: zero gradient in exact arithmetic)
    and is not compared."""
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).max() if b.size else 0.0
        if what in ("mu", "nu") and scale < 1e-8:
            continue
        scale = max(scale, 1e-12)
        assert np.abs(a - b).max() <= tol * scale + atol, (
            what, a.shape, np.abs(a - b).max(), scale)


@pytest.mark.parametrize("scenario", ["dp", "tp"])
def test_bilinear_step_matches_jax(runs, scenario):
    """Dropout 0: DP (2 ranks) and DP x TP (2 x 2) against JAX's
    single-device step; JAX's own TP step is held to it too."""
    jstate, jloss = runs["jax"]["step"]
    tstate, tloss = runs["jax"]["tp"]
    assert tloss == pytest.approx(jloss, rel=2e-4)
    assert _digest(tstate.params) == pytest.approx(_digest(jstate.params),
                                                   rel=2e-4)
    for r in runs["out"][scenario]:
        params, stats, _ = r["step0"]["trees"]
        assert r["step0"]["loss"] == pytest.approx(jloss, rel=2e-4)
        assert _digest(params) == pytest.approx(_digest(jstate.params),
                                                rel=2e-4)
        np.testing.assert_allclose(
            np.asarray(stats["encode"]["bn"]["mean"]),
            np.asarray(jstate.batch_stats["encode"]["bn"]["mean"]),
            rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("scenario", ["dp", "tp"])
@pytest.mark.parametrize("step", ["step0", "step5"])
def test_bilinear_step_matches_one_process(runs, scenario, step):
    """At dropout 0 and 0.5 (the global batch's masks, sliced), every
    rank's gathered state equals the port's one-process step."""
    want = runs["one"][step]
    for r in runs["out"][scenario]:
        got = r[step]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        params, stats, adam = got["trees"]
        _leafwise(params, want["trees"][0], 1e-5, "params", atol=1e-4)
        _leafwise(stats, want["trees"][1], 1e-5, "stats")
        _leafwise(adam["1"]["mu"], want["trees"][2]["1"]["mu"], 1e-4, "mu")
        _leafwise(adam["1"]["nu"], want["trees"][2]["1"]["nu"], 1e-4, "nu")


def test_tp_clips_by_the_global_norm(runs):
    """The step's gradient norm is above the clip (so the clip acts), the
    same on every rank, and the update matches one process (above)."""
    norms = [r["step0"]["norm"][0] for r in runs["out"]["tp"]]
    assert min(norms) > 1.0
    assert max(norms) == pytest.approx(min(norms), rel=1e-6)


def test_dp_epoch_with_a_tail_matches_one_process(runs):
    """29 rows in batches of 16: the tail's 13 rows split 6 / 7, weighted
    by the global count."""
    want = runs["one"]["epoch"]
    for r in runs["out"]["dp"]:
        np.testing.assert_allclose(r["epoch"]["losses"], want["losses"],
                                   rtol=1e-5)
        _leafwise(r["epoch"]["trees"][0], want["trees"][0], 1e-5, "params",
                  atol=1e-4)
        # The later steps start from the first step's amplified moves.
        _leafwise(r["epoch"]["trees"][1], want["trees"][1], 1e-4, "stats")


def test_dp_hourglass_step_matches_one_process_and_jax(runs):
    jloss = runs["jax"]["hourglass"]
    for r in runs["out"]["dp"]:
        got, want = r["hourglass"], runs["one"]["hourglass"]
        assert got["loss"] == pytest.approx(jloss, rel=2e-4)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        _leafwise(got["trees"][1], want["trees"][1], 1e-5, "bn statistics")
        # Computed in float64, the two runs differ by the order of the
        # sums alone; the parameters, so their gradients, stay f32. A conv
        # bias in front of a train-mode BN has a zero gradient in exact
        # arithmetic: its rounding noise (below 1e-10) is not compared.
        # RMSprop's first step, lr g / (0.1 |g| + eps), amplifies a
        # gradient's rounding where |g| nears eps: the gradients are the
        # exactness check, the parameters get JAX's amplified gate.
        got, want = r["hourglass64"], runs["one"]["hourglass64"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-12)
        assert set(got["grads"]) == set(want["grads"])
        mine = wt.hourglass_torch7_from_jax(*got["trees"][:2])
        ref_sd = wt.hourglass_torch7_from_jax(*want["trees"][:2])
        for k, g in got["grads"].items():
            ref = want["grads"][k]
            scale = float(ref.abs().max())
            if scale < 1e-10:
                continue
            assert (g - ref).abs().max() <= 1e-6 * scale, k
            m = ref.abs() > 3e-5
            np.testing.assert_allclose(mine[k][m].numpy(),
                                       ref_sd[k][m].numpy(), rtol=2e-3,
                                       atol=2e-4, err_msg=k)
        _leafwise(got["trees"][1], want["trees"][1], 1e-6, "stats")


def test_dp_end2end_step_matches_one_process(runs):
    """End2EndTrainer over 2 ranks, in float64: the global batch's draws
    and lifter dropout masks sliced, global BN in the detector and the
    lifter, the losses and gradients of the whole batch. The two runs
    differ by the order of their sums alone (measured: losses 4e-15,
    gradients 9e-12 and statistics 6e-13 of their leaf's largest value).
    A gradient that is zero in exact arithmetic (a bias in front of a
    train-mode BN, below 1e-10) is not compared."""
    want = runs["one"]["end2end"]
    for r in runs["out"]["dp"]:
        got = r["end2end"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-12)
        _leafwise(got["trees"][1], want["trees"][1], 1e-10, "statistics")
        assert set(got["grads"]) == set(want["grads"])
        for k, g in got["grads"].items():
            ref = want["grads"][k]
            scale = float(ref.abs().max())
            if scale >= 1e-10:
                assert (g - ref).abs().max() <= 1e-9 * scale, k


def test_cli_two_ranks_write_once_and_resume(runs):
    """Rank 0 alone writes 1.save and debug.log; its state equals a
    one-process run's epoch; a one-process run resumes from it."""
    pdir = os.path.join(runs["dp_root"], "dp", "parameter")
    assert sorted(os.listdir(pdir)) == ["1.save"]
    dp = pckpt.load_checkpoint(pdir, 1)
    one = pckpt.load_checkpoint(
        os.path.join(runs["cli_one"], "dp", "parameter"), 1)
    assert dp["step"] == one["step"]
    _leafwise(dp["state"]["params"], one["state"]["params"], 1e-5,
              "params", atol=1e-4)
    train_bilinear.main(runs["cli_args"] + ["--save-root", runs["dp_root"]])
    assert sorted(os.listdir(pdir)) == ["1.save", "2.save"]
    with open(os.path.join(runs["dp_root"], "dp", "debug.log")) as f:
        log = f.read()
    assert log.count("Architecture") == 2  # rank 0's run and the resume
    assert "Resumed from epoch 1" in log


def _grads_close(got, want, tol):
    """Each gradient within ``tol`` of its leaf's largest value; a
    gradient that is zero in exact arithmetic (a bias in front of a
    train-mode BN, below 1e-10) is rounding noise and not compared."""
    assert set(got) == set(want)
    for k, g in got.items():
        ref = want[k]
        scale = float(ref.abs().max())
        if scale >= 1e-10:
            assert (g - ref).abs().max() <= tol * scale, k


def test_dp_fused_hourglass_step_matches_one_process_and_jax(runs):
    """``HourglassTrainer(fused_blocks=True)`` over 2 ranks, the whole
    model in float64: each block's BN reductions merged over the data group
    in rank order (K3/K4's plain versions), so the step is the one-process
    step on the global batch (losses, gradients, the running statistics
    updated once with the global count, dgamma and dbeta summed once)."""
    want = runs["one"]["hourglass_fused"]
    for r in runs["out"]["dp"]:
        got = r["hourglass_fused"]
        assert got["loss"] == pytest.approx(runs["jax"]["hourglass_fused"],
                                            rel=2e-4)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-12)
        _leafwise(got["trees"][1], want["trees"][1], 1e-10, "statistics")
        _grads_close(got["grads"], want["grads"], 1e-9)


def test_dp_fused_step_with_an_empty_rank_matches_one_process(runs):
    """The fused detector's step on one row over 2 ranks: rank 0 holds
    none, sends rows of count 0 (the forward) and of zeros (the backward)
    to every merge and still updates its running statistics; both ranks
    hold the one-process step."""
    want = runs["one"]["hourglass_fused_one_row"]
    for r in runs["out"]["dp"]:
        got = r["hourglass_fused_one_row"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-12)
        _leafwise(got["trees"][1], want["trees"][1], 1e-10, "statistics")
        _grads_close(got["grads"], want["grads"], 1e-9)


def test_dp_fused_end2end_step_matches_one_process(runs):
    """``End2EndTrainer`` with ``model_kw={"fused": True}`` over 2 ranks,
    in float64, against one process on the global batch."""
    want = runs["one"]["end2end_fused"]
    for r in runs["out"]["dp"]:
        got = r["end2end_fused"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-12)
        _leafwise(got["trees"][1], want["trees"][1], 1e-10, "statistics")
        _grads_close(got["grads"], want["grads"], 1e-9)


def test_fused_blocks_take_any_data_mesh():
    """The detector trainers take fused blocks at any data mesh (one rank
    is no mesh: the unstaged kernels); a model axis is refused."""
    for data in (1, 2):
        th.HourglassTrainer(device="cpu", mesh=pmesh.Mesh(data=data, model=1),
                            fused_blocks=True, **HG_SIZE)
    with pytest.raises(ValueError, match="tensor parallelism"):
        th.HourglassTrainer(device="cpu", mesh=pmesh.Mesh(data=1, model=2),
                            fused_blocks=True, **HG_SIZE)


def test_row_blocks_and_batch_like_leaves():
    mesh = pmesh.Mesh(data=2, model=2, rank=3)
    assert (mesh.data_index, mesh.model_index) == (1, 1)
    assert mesh.rows(13) == (6, 13)
    assert [pmesh.row_block(13, i, 2) for i in range(2)] == [(0, 6), (6, 13)]
    got = pmesh.local_rows(mesh, {"x": np.arange(13), "y": np.arange(13)})
    np.testing.assert_array_equal(got["x"], np.arange(6, 13))
    with pytest.raises(ValueError, match="batch-like"):
        pmesh.local_rows(mesh, {"x": np.arange(13), "s": np.float32(1)})
    with pytest.raises(ValueError, match="one batch"):
        pmesh.local_rows(mesh, {"x": np.arange(13), "mean": np.zeros(32)})
    # The trainers' trees: a dict and a NamedTuple of NamedTuples, whose
    # per-batch int and generator pass through.
    batch = {"images": torch.arange(13.0)}
    draws = E2EAugment(
        aug.AugmentParams(torch.arange(13.0), torch.zeros(13),
                          torch.zeros(13, dtype=torch.bool)),
        aug.JitterParams(*(torch.ones(13),) * 4, 2), torch.Generator())
    got_batch, got_draws = pmesh.local_rows(mesh, (batch, draws))
    assert type(got_draws) is E2EAugment
    assert got_draws.dropout is draws.dropout
    assert got_draws.jitter.order == 2
    np.testing.assert_array_equal(got_batch["images"].numpy(),
                                  np.arange(6.0, 13.0))
    np.testing.assert_array_equal(got_draws.geometry.scale_factor.numpy(),
                                  np.arange(6.0, 13.0))
    with pytest.raises(ValueError, match="batch-like"):
        pmesh.local_rows(mesh, (batch, draws._replace(
            jitter=draws.jitter._replace(order=torch.tensor(2)))))


@pytest.mark.parametrize("world, per_host, device, cards, pid, want", [
    (2, 0, "cpu", None, 1, ("cpu", "gloo")),
    (2, 0, "", 1, 1, ("cuda:0", "gloo")),  # two ranks share one card
    (2, 0, "", 2, 1, ("cuda:1", "nccl")),
    (1, 0, "cuda:0", None, 0, ("cuda:0", "nccl")),
    (2, 0, "cuda:1", None, 0, ("cuda:1", "gloo")),  # an explicit shared card
    # Two hosts of 8 cards, 8 ranks each: rank 13 is host 1's local rank 5.
    (16, 8, "", 8, 13, ("cuda:5", "nccl")),
    (16, 8, "", 4, 13, ("cuda:1", "gloo")),
])
def test_backend_follows_the_layout(world, per_host, device, cards, pid,
                                    want):
    dev, backend = pmesh.rank_layout(world, pid, per_host, device, cards)
    assert (dev, backend) == (torch.device(want[0]), want[1])


def test_layout_and_stage_errors():
    from bilinear_tpu_torch.config import HourglassConfig, parse_config

    cfg = parse_config(HourglassConfig(), ["--local-processes", "8"])
    assert cfg.local_processes == 8
    with pytest.raises(ValueError, match="do not fill hosts"):
        pmesh.rank_layout(6, 0, 4, "cpu")
    with pytest.raises(ValueError, match="devices are available"):
        pmesh.make_stage_mesh(["cpu"] * 2, stages=3)


# ------------------------------------------------------ the mesh servers


@pytest.mark.parametrize("quantize", [None, "int8", "int8-static"])
def test_lifting_server_mesh(quantize):
    params, stats = scrambled_variables(0)
    ones = (np.zeros(32), np.ones(32), np.zeros(48), np.ones(48))
    kw = dict(dtype=torch.bfloat16, quantize=quantize)
    flat = LiftingServer(params, stats, *ones, device="cpu", **kw)
    mesh = LiftingServer(params, stats, *ones, mesh=["cpu"] * 2, **kw)
    x = rows(37, seed=1)  # padded to 38: blocks of 19 rows
    got = mesh.lift_normalized(x).numpy()
    pad = np.concatenate([x, np.zeros((1, 32), np.float32)])
    blocks = np.concatenate([flat.lift_normalized(pad[:19]).numpy(),
                             flat.lift_normalized(pad[19:]).numpy()])[:37]
    np.testing.assert_array_equal(got, blocks)
    if quantize is None:  # row-independent: the whole batch's rows too
        np.testing.assert_allclose(got, flat.lift_normalized(x).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_end2end_server_mesh():
    from bilinear_tpu_torch.models.end2end import End2End

    model = End2End(generator=torch.Generator().manual_seed(0), **HG_SIZE)
    variables = dict(zip(("params", "batch_stats"),
                         wt.end2end_to_jax(model.state_dict(), "torch7")))
    stats = (np.zeros(32), np.ones(32), np.zeros(48), np.ones(48))
    kw = dict(variant="torch7", dtype=torch.float32, batch_sizes=(2, 4),
              model_kw=HG_SIZE)
    flat = End2EndServer(variables, *stats, device="cpu", **kw)
    mesh = End2EndServer(variables, *stats, mesh=["cpu"] * 2, **kw)
    frames = (np.random.RandomState(0).rand(5, 256, 256, 3) * 255) \
        .astype(np.uint8)
    p2, p3 = mesh.predict(frames)
    q2, q3 = flat.predict(frames)
    np.testing.assert_allclose(p2, q2, rtol=0, atol=1e-3)
    np.testing.assert_allclose(p3, q3, rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="do not divide the mesh's data"):
        End2EndServer(variables, *stats, mesh=["cpu"] * 2,
                      **dict(kw, batch_sizes=(1, 4)))
