"""The port's detector trainer CLI (bilinear_tpu_torch/cli/train_hourglass.py)
at a tiny size on the CPU: two invocations (the second resumes), and
checkpoints that cross between the packages both ways: a port
``{epoch}.save`` restores in the JAX package's io/checkpoint.resume_or_init
with equal parameters, statistics and RMSprop state, and a JAX one restores
in the port. Exact equality: both sides carry the same f32 numbers.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.io import checkpoint as jckpt
from bilinear_tpu.train.hourglass import HourglassTrainer as JaxTrainer
from bilinear_tpu_torch.cli import train_hourglass
from bilinear_tpu_torch.data.synthetic import write_mpii_dataset
from bilinear_tpu_torch.io import checkpoint as pckpt
from bilinear_tpu_torch.train.hourglass import HourglassTrainer
from torch_port_fixtures import one_torch_thread  # noqa: F401

SIZE = dict(n_stacks=1, features=16, depth=2)
ARGS = ["--n-stacks", "1", "--features", "16", "--depth", "2",
        "--batch-size", "4", "--canvas", "256", "--device", "cpu",
        "--fused-blocks", "true", "--steps-per-dispatch", "2"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("hg")
    data = str(root / "mpii")
    write_mpii_dataset(data, n_train_images=6, n_test_images=1,
                       learnable=True)
    argv = ARGS + ["--data-dir", data, "--save-root", str(root / "save"),
                   "--comment", "tiny", "--epochs-per-run", "1"]
    train_hourglass.main(argv)
    train_hourglass.main(argv)
    return str(root / "save" / "tiny")


@pytest.fixture(scope="module")
def jax_template():
    return JaxTrainer(**SIZE).init_state(jax.random.PRNGKey(0))


def test_cli_trains_two_epochs_and_resumes(run):
    assert sorted(os.listdir(os.path.join(run, "parameter"))) == \
        ["1.save", "2.save"]
    with open(os.path.join(run, "debug.log")) as f:
        log = f.read()
    assert "Resumed from epoch 1 (step 3)" in log
    losses = [float(line.split("loss: ")[1].split(",")[0])
              for line in log.splitlines() if "saved (loss:" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    payload = pckpt.load_checkpoint(os.path.join(run, "parameter"), 2)
    assert payload["epoch"] == 2 and payload["step"] == 5
    assert int(payload["optimizer"]["1"]["count"]) == 4


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_hourglass.main(["--data-dir", str(tmp_path)])


def _assert_trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, leaf in la:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(lb[path]),
                                      err_msg=jax.tree_util.keystr(path))


def test_port_checkpoint_restores_in_jax(run, jax_template):
    pdir = os.path.join(run, "parameter")
    payload = pckpt.load_checkpoint(pdir, 2)
    state, epoch = jckpt.resume_or_init(jax_template, pdir)
    assert epoch == 2 and int(state.step) == 5
    _assert_trees_equal(state.params, payload["state"]["params"])
    _assert_trees_equal(state.batch_stats, payload["state"]["batch_stats"])
    rms = state.opt_state[1]
    assert int(rms.count) == 4
    _assert_trees_equal(rms.square_avg,
                        payload["optimizer"]["1"]["square_avg"])
    assert float(jnp.abs(jax.tree.leaves(rms.square_avg)[0]).sum()) > 0


def test_jax_checkpoint_restores_in_port(tmp_path, jax_template):
    """A JAX payload with non-trivial RMSprop state through the port's
    TrainState.restore and back out of TrainState.trees."""
    rng = np.random.RandomState(0)
    state = jax_template.replace(
        opt_state=(jax_template.opt_state[0], jax_template.opt_state[1]
                   ._replace(count=jnp.asarray(3, jnp.int32),
                             square_avg=jax.tree.map(
                                 lambda v: jnp.asarray(rng.rand(*v.shape),
                                                       jnp.float32),
                                 jax_template.opt_state[1].square_avg))),
        step=jnp.asarray(4, jnp.int32))
    pdir = str(tmp_path / "parameter")
    jckpt.save_checkpoint(pdir, 7, state)
    port = HourglassTrainer(**SIZE, fused_blocks=True, device="cpu") \
        .init_state(1)
    port, epoch = pckpt.resume_or_init(port, pdir)
    assert epoch == 7 and port.step == 4 and port.optimizer.count == 3
    params, stats, opt = port.trees()
    payload = jckpt.load_checkpoint(pdir, 7)
    _assert_trees_equal(params, payload["state"]["params"])
    _assert_trees_equal(stats, payload["state"]["batch_stats"])
    _assert_trees_equal(opt, payload["optimizer"])


def test_train_step_carries_its_profiler_ranges(run):
    """One CPU-profiled step of the trainer shows each of STEP_RANGES once,
    in order, nested in nothing: what a host-time split of the step reads."""
    from torch.profiler import ProfilerActivity, profile

    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
    from bilinear_tpu_torch.train import hourglass as th

    data = os.path.join(os.path.dirname(os.path.dirname(run)), "mpii")
    pipe = MPIIHostPipeline(MPIIAnnotations(data, Task.Train), 2, canvas=256,
                            transport="u8")
    trainer = HourglassTrainer(**SIZE, fused_blocks=True, device="cpu")
    state = trainer.init_state(0)
    batch = trainer.batch_tensors(next(iter(pipe.epoch(1, prefetch=0))))
    aug = th.sample_augment(th.step_generator(0, 1, 1), 2)
    before = state.step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = trainer.train_step(state, batch, aug)
    assert np.isfinite(float(loss)) and state.step == before + 1
    ranges = sorted((e for e in prof.events() if e.name in th.STEP_RANGES),
                    key=lambda e: e.time_range.start)
    assert tuple(e.name for e in ranges) == th.STEP_RANGES
    for a, b in zip(ranges, ranges[1:]):
        assert a.time_range.end <= b.time_range.start
