"""The port's ``cli/doctor.py`` and its reader of the reference's torch
checkpoints (``utils/weights.py::load_reference_bilinear_checkpoint``), on
the CPU.

- ``doctor --device cpu``: one JSON object with every probe, exit code 0;
  a probe that raises is reported and makes the exit code 1; the
  checkpoint probe equals JAX's ``probe_checkpoints`` on the same run.
- The reader: a lifter trained two steps (Adam's moments non-zero),
  written in the reference's format by ``export_torch.reference_checkpoint``
  and read back by the port's reader and by JAX's
  (``utils/torch_compat.py::load_reference_bilinear_checkpoint``):
  parameters, BN statistics, Adam's count, mu and nu exactly equal to the
  writer's; the reader's next step equal to the writer's next step (the
  loss and every parameter to 1e-6).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from bilinear_tpu.cli import doctor as jax_doctor
from bilinear_tpu.train.bilinear import BilinearTrainer as JaxBilinear
from bilinear_tpu.utils.torch_compat import \
    load_reference_bilinear_checkpoint as jax_load_reference
from bilinear_tpu_torch.cli import doctor
from bilinear_tpu_torch.cli.export_torch import reference_checkpoint
from bilinear_tpu_torch.io import checkpoint as pckpt
from bilinear_tpu_torch.models.bilinear import BilinearUnit
from bilinear_tpu_torch.train.bilinear import BilinearTrainer
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread  # noqa: F401

PROBES = {"platform", "memory", "dispatch", "sync", "transfer", "matmul",
          "kernels", "checkpoints"}


def _run(capsys, argv):
    rc = doctor.main(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_doctor_on_the_cpu(tmp_path, capsys):
    run = str(tmp_path / "run")
    pckpt.save_checkpoint(os.path.join(run, "parameter"), 3, {}, {}, {},
                          step=7)
    rc, report = _run(capsys, ["--device", "cpu", "--matmul-n", "128",
                               "--sync-n", "64", "--mb", "1",
                               "--run-dir", run])
    assert rc == 0 and set(report) == PROBES
    assert all("error" not in v for v in report.values())
    assert report["platform"]["device"] == "cpu"
    assert report["matmul"]["note"].startswith("CPU requested")
    assert set(report["kernels"]["cuda"]) == {
        "conv_epilogue", "int8_conv", "int8_scale_probe", "lifting",
        "lifting_int8", "resmodule"}
    assert report["checkpoints"] == jax_doctor.probe_checkpoints(run)


def test_doctor_reports_a_failed_probe(capsys, monkeypatch):
    def broken(dev):
        raise RuntimeError("planted")

    monkeypatch.setattr(doctor, "probe_memory", broken)
    rc, report = _run(capsys, ["--device", "cpu", "--skip", "matmul",
                               "transfer", "sync"])
    assert rc == 1
    assert report["memory"] == {"error": "RuntimeError: planted"}
    assert report["matmul"] == {"skipped": True}
    assert "checkpoints" not in report


def test_doctor_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        doctor.main([])


def _step(trainer, state, seed):
    rng = np.random.RandomState(seed)
    bx = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    by = torch.from_numpy(rng.randn(64, 48).astype(np.float32))
    return float(trainer.train_step(state, bx, by, None))


def _leaves(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def test_reference_checkpoint_reads_back_in_both_packages(tmp_path):
    assert [k for k, _, _ in wt.bilinear_param_paths()] == \
        [k for k, _ in BilinearUnit().named_parameters()]
    trainer = BilinearTrainer(batch_size=64, learning_rate=1e-3,
                              dropout=0.0, device="cpu")
    writer = trainer.init_state(0)
    for s in range(2):
        _step(trainer, writer, s)
    params, stats, opt = writer.trees()
    payload = {"epoch": 4, "step": writer.step,
               "state": {"params": params, "batch_stats": stats},
               "optimizer": opt}
    path = str(tmp_path / "4.save")
    torch.save(reference_checkpoint(payload, "bilinear", 4, 1e-3), path)

    reader, epoch = wt.load_reference_bilinear_checkpoint(
        path, trainer.init_state(1))
    assert epoch == 4 and reader.step == writer.step
    rp, rs, ro = reader.trees()
    _equal(rp, params)
    _equal(rs, stats)
    assert int(ro["1"]["count"]) == int(opt["1"]["count"]) == 2
    _equal(ro["1"]["mu"], opt["1"]["mu"])
    _equal(ro["1"]["nu"], opt["1"]["nu"])

    jstate, jepoch = jax_load_reference(
        path, JaxBilinear(batch_size=64).init_state(jax.random.PRNGKey(0)))
    assert jepoch == 4 and int(jstate.step) == writer.step
    _equal(jax.device_get(jstate.params), params)
    _equal(jax.device_get(jstate.batch_stats), stats)
    adam = jstate.opt_state[1]
    assert int(adam.count) == 2
    _equal(jax.device_get(adam.mu), opt["1"]["mu"])
    _equal(jax.device_get(adam.nu), opt["1"]["nu"])

    want, got = _step(trainer, writer, 5), _step(trainer, reader, 5)
    assert got == pytest.approx(want, rel=1e-6)
    for a, b in zip(_leaves(reader.trees()[0]), _leaves(writer.trees()[0])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
