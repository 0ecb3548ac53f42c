"""``--debug-nans`` (utils/debug.py), graceful preemption
(utils/preempt.py) and ``--profile`` (utils/profiling.py) of the port's
training CLIs, on the CPU.

- ``--debug-nans``: a clean train_bilinear run with it passes; a run
  resumed from a checkpoint with an infinity planted in a weight stops
  with ``FloatingPointError`` naming the module, in the port's
  train_bilinear and, for a fused block's weight, train_hourglass (K3's
  outputs, checked by the fused block itself); JAX's train_bilinear with
  ``--debug-nans`` stops on the same checkpoint with ``FloatingPointError``
  too. The tree checks agree with JAX's ``assert_tree_finite``.
- Preemption: a train_bilinear process signals itself (SIGTERM) during
  epoch 1 of 3: it finishes the epoch, writes 1.save only, exits 0, and a
  rerun resumes to 2.save. Over 2 gloo ranks, rank 1 alone is signalled:
  both ranks stop after epoch 1 (``global_requested``), rank 0 wrote
  1.save only. ``GracefulShutdown``'s latch, re-arm and restore, step by
  step as JAX's.
- ``--profile``: train_bilinear writes a Chrome trace under
  ``{run}/plugins/profile/``, where JAX's ``trace`` writes; a profiled ``HourglassTrainer`` step's trace
  names every ``STEP_RANGES`` range (the lifting trainer has none).
"""
import glob
import json
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.cli import train_bilinear as jax_train_bilinear
from bilinear_tpu.utils import debug as jax_debug
from bilinear_tpu.utils import preempt as jax_preempt
from bilinear_tpu.utils import profiling as jax_profiling
from bilinear_tpu_torch.cli import train_bilinear, train_hourglass
from bilinear_tpu_torch.data.synthetic import write_h36m_dataset, \
    write_mpii_dataset
from bilinear_tpu_torch.io import checkpoint as pckpt
from bilinear_tpu_torch.models.detectors import make_model
from bilinear_tpu_torch.train import hourglass as th
from bilinear_tpu_torch.utils import debug, preempt, profiling
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def h36m(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("h36m"))
    write_h36m_dataset(data, n_train=64, n_valid=16)  # one step per epoch
    return data


def _bilinear_argv(data, root, *extra):
    return ["--data-dir", data, "--save-root", root, "--comment", "bi",
            "--batch-size", "64", "--device", "cpu", *extra]


# ------------------------------------------------------------ --debug-nans


def _plant_inf(pdir, path):
    """Rewrite ``pdir``'s 1.save with +inf at element 0 of the parameter
    leaf at ``path``."""
    payload = pckpt.load_checkpoint(pdir, 1)
    leaf = np.array(wt.get_leaf(payload["state"]["params"], path))
    leaf.flat[0] = np.inf
    wt.put_leaf(payload["state"]["params"], path, leaf)
    pckpt.save_checkpoint(pdir, 1, payload["state"]["params"],
                          payload["state"]["batch_stats"],
                          payload["optimizer"], step=payload["step"])


def test_debug_nans_bilinear_port_and_jax(h36m, tmp_path):
    root = str(tmp_path / "save")
    train_bilinear.main(_bilinear_argv(h36m, root, "--epochs-per-run", "1",
                                       "--debug-nans", "true"))
    pdir = os.path.join(root, "bi", "parameter")
    assert sorted(os.listdir(pdir)) == ["1.save"]  # the clean run passed
    _plant_inf(pdir, ("encode", "linear", "kernel"))
    with pytest.raises(FloatingPointError, match=r"output of encode\."):
        train_bilinear.main(_bilinear_argv(h36m, root, "--epochs-per-run",
                                           "1", "--debug-nans", "true"))
    with pytest.raises(FloatingPointError):
        jax_train_bilinear.main(["--data-dir", h36m, "--save-root", root,
                                 "--comment", "bi", "--batch-size", "64",
                                 "--epochs-per-run", "1",
                                 "--debug-nans", "true"])


def test_debug_nans_names_the_fused_block(tmp_path):
    data = str(tmp_path / "mpii")
    write_mpii_dataset(data, n_train_images=2, n_test_images=1)
    argv = ["--n-stacks", "1", "--features", "64", "--depth", "1",
            "--batch-size", "2", "--canvas", "256", "--device", "cpu",
            "--fused-blocks", "true", "--data-dir", data, "--save-root",
            str(tmp_path / "save"), "--comment", "hg", "--epochs-per-run",
            "1", "--debug-nans", "true"]
    train_hourglass.main(argv)
    pdir = str(tmp_path / "save" / "hg" / "parameter")
    sd = dict(make_model("torch7", n_stacks=1, features=64, depth=1)
           .named_parameters())
    key = "hgArray.0.res1.0.resSeq.2.weight"  # its first 1x1 conv
    path = {k: p for k, p, _ in wt.torch7_param_paths(
        dict(n_stacks=1, features=64, depth=1, n_modules=1))}[key]
    assert key in sd
    _plant_inf(pdir, path)
    with pytest.raises(FloatingPointError,
                       match=r"K3's outputs in hgArray\.0\.res1\.0"):
        train_hourglass.main(argv)


def test_tree_checks_agree_with_jax():
    good = {"a": torch.ones(3), "b": [torch.zeros(2), torch.arange(3)]}
    bad = {"a": torch.ones(3), "b": [torch.tensor([0.0, float("nan")])]}
    assert debug.tree_all_finite(good) and not debug.tree_all_finite(bad)
    debug.assert_tree_finite(good)
    with pytest.raises(FloatingPointError, match=r"\['b'\]\[0\]"):
        debug.assert_tree_finite(bad, "grads")
    jbad = {"a": jnp.ones(3), "b": [jnp.asarray([0.0, jnp.nan])]}
    assert not bool(jax_debug.tree_all_finite(jbad))
    with pytest.raises(FloatingPointError):
        jax_debug.assert_tree_finite(jbad)
    # Outside debug mode nothing is checked.
    debug.check([torch.tensor([float("inf")])], "anything")


# --------------------------------------------------------------- preemption

_SELF_SIGNAL = r"""
import os, signal, sys
from bilinear_tpu_torch.cli import train_bilinear
from bilinear_tpu_torch.train.bilinear import BilinearTrainer

argv = sys.argv[1:]
rank = int(argv[argv.index("--process-id") + 1]) \
    if "--process-id" in argv else 0
run_epoch = BilinearTrainer.train_epoch


def train_epoch(self, state, x, y, epoch, seed):
    if epoch == 1 and rank == int(os.environ["SIGNAL_RANK"]):
        os.kill(os.getpid(), signal.SIGTERM)  # lands inside epoch 1
    return run_epoch(self, state, x, y, epoch, seed)


BilinearTrainer.train_epoch = train_epoch
train_bilinear.main(argv)
"""


def _env(signal_rank):
    return dict(os.environ, SIGNAL_RANK=str(signal_rank), OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def test_sigterm_finishes_the_epoch_and_resumes(h36m, tmp_path):
    root = str(tmp_path / "save")
    argv = _bilinear_argv(h36m, root, "--epochs-per-run", "3")
    p = subprocess.run([sys.executable, "-c", _SELF_SIGNAL, *argv],
                       env=_env(0), cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    pdir = os.path.join(root, "bi", "parameter")
    assert sorted(os.listdir(pdir)) == ["1.save"]
    log = open(os.path.join(root, "bi", "debug.log")).read()
    assert "SIGTERM received" in log and "Preempted after epoch 1/3" in log
    train_bilinear.main(_bilinear_argv(h36m, root, "--epochs-per-run", "1"))
    assert sorted(os.listdir(pdir)) == ["1.save", "2.save"]
    assert "Resumed from epoch 1" in open(
        os.path.join(root, "bi", "debug.log")).read()


def test_one_signalled_rank_stops_both(h36m, tmp_path):
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    root = str(tmp_path / "save")
    argv = _bilinear_argv(h36m, root, "--epochs-per-run", "3",
                          "--coordinator", f"localhost:{port}",
                          "--num-processes", "2")
    procs = [subprocess.Popen([sys.executable, "-c", _SELF_SIGNAL, *argv,
                               "--process-id", str(r)], env=_env(1),
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    assert sorted(os.listdir(os.path.join(root, "bi", "parameter"))) == \
        ["1.save"]
    log = open(os.path.join(root, "bi", "debug.log")).read()
    assert "Preempted after epoch 1/3" in log  # rank 0, not signalled


@pytest.mark.parametrize("module", [preempt, jax_preempt],
                         ids=["port", "jax"])
def test_graceful_shutdown_latches_rearms_and_restores(module):
    """The port's latch behaves as JAX's, step by step."""
    calls = []
    prev = signal.signal(signal.SIGUSR1, lambda *a: calls.append(a))
    try:
        with module.GracefulShutdown(signals=(signal.SIGUSR1,)) as stop:
            assert stop.requested is False
            os.kill(os.getpid(), signal.SIGUSR1)
            assert stop.requested is True and calls == []
            os.kill(os.getpid(), signal.SIGUSR1)  # the second one passes
            assert len(calls) == 1
        os.kill(os.getpid(), signal.SIGUSR1)  # restored on exit
        assert len(calls) == 2
    finally:
        signal.signal(signal.SIGUSR1, prev)
    assert module.global_requested(True) is True
    assert module.global_requested(False) is False


def test_graceful_shutdown_outside_the_main_thread():
    import threading

    out = []

    def body():
        with preempt.GracefulShutdown(signals=(signal.SIGUSR1,)) as stop:
            out.append(stop.requested)

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert out == [False]


# ---------------------------------------------------------------- --profile


def test_profile_writes_a_trace(h36m, tmp_path):
    """Under the run directory, where JAX's ``trace`` writes its profile
    (``{log_dir}/plugins/profile``)."""
    with jax_profiling.trace(str(tmp_path / "jax")):
        jnp.ones(4).sum().block_until_ready()
    assert os.path.isdir(tmp_path / "jax" / "plugins" / "profile")
    root = str(tmp_path / "save")
    train_bilinear.main(_bilinear_argv(h36m, root, "--epochs-per-run", "1",
                                       "--profile", "true"))
    traces = glob.glob(os.path.join(root, "bi", "plugins", "profile",
                                    "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::addmm" in names or "aten::linear" in names


def test_profiled_hourglass_step_names_its_ranges(tmp_path):
    trainer = th.HourglassTrainer(n_stacks=1, features=16, depth=1,
                                  device="cpu")
    state = trainer.init_state(0)
    rng = np.random.RandomState(0)
    batch = {"images": torch.from_numpy(rng.rand(2, 128, 128, 3)
                                        .astype(np.float32)),
             "centers": torch.full((2, 2), 64.0),
             "scales": torch.full((2,), 0.5),
             "keypoints": torch.full((2, 16, 2), 60.0),
             "valid": torch.ones((2, 16), dtype=torch.bool)}
    with profiling.trace(str(tmp_path)) as prof:
        trainer.train_step(state, batch,
                           th.sample_augment(th.step_generator(0, 1, 1), 2))
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(th.STEP_RANGES) <= names
