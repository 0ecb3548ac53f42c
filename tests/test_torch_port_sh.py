"""The port's SH conversion and the whole protocol chain on the CPU
(bilinear_tpu_torch: data/sh_convert.py, cli/sh_preprocess.py,
cli/train_hourglass_ft.py, cli/valid_hourglass_ft.py), and the precision
every CLI sets:

- the SH+FT bins that the JAX package's ``sh_preprocess.main`` and the
  port's write from one tiny preact checkpoint;
- the port's copy of the JAX package's tests/test_protocol_chain.py:
  train_hourglass -> train_hourglass_ft -> sh_preprocess --protocol-out
  SH+FT -> train_bilinear --protocol SH+FT -> valid_bilinear, with
  ``--device cpu``, on the same tiny trees and with the same asserts, plus
  valid_hourglass_ft, valid_hourglass, eval_hourglass and serve on what it
  trained;
- every CLI's ``main`` turns TF32 off for matmuls and cuDNN, whatever it
  was before.
"""
import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from bilinear_tpu.cli import sh_preprocess as jax_sh_preprocess
from bilinear_tpu.io import checkpoint as jckpt
from bilinear_tpu.train.hourglass import HourglassTrainer as JaxTrainer
from bilinear_tpu_torch.cli import (eval_hourglass, serve, sh_preprocess,
                                    train_bilinear, train_hourglass,
                                    train_hourglass_ft, valid_bilinear,
                                    valid_hourglass, valid_hourglass_ft)
from bilinear_tpu_torch.data.h36m import Protocol, Task, load_h36m
from bilinear_tpu_torch.data.synthetic import write_h36m_dataset, \
    write_mpii_dataset
from bilinear_tpu_torch.serving_http import PoseHTTPServer
from torch_port_fixtures import one_torch_thread  # noqa: F401

TINY = ["--n-stacks", "1", "--features", "8", "--depth", "1"]
CPU = ["--device", "cpu"]


# ------------------------------------------------------ SH conversion


def _bins(h36m, protocol):
    out = {}
    for task in ("train", "valid"):
        with open(os.path.join(h36m, f"{task}_{protocol}.bin"), "rb") as f:
            out[task] = pickle.load(f)
    return out


def test_sh_bins_match_jax(tmp_path):
    """One tiny preact checkpoint (the JAX trainer's initial state, 2
    stacks, 16 features, depth 2), converted by both packages on copies of
    one H36M tree. Every key but ``part`` is the GT bin's, exactly; ``part``
    agrees on at least 95% of the joints (measured: all of them, 0 pixels
    apart), and no
    joint is farther apart than one heatmap cell in image pixels (200 *
    scale / 64): the two forwards are ~5e-7 apart, so only an argmax whose
    top two cells tie that closely can move."""
    mine = write_h36m_dataset(str(tmp_path / "mine"), n_train=8, n_valid=4,
                              with_images=True)
    theirs = str(tmp_path / "theirs")
    shutil.copytree(mine, theirs)
    sroot = str(tmp_path / "save")
    size = dict(n_stacks=2, features=16, depth=2)
    state = JaxTrainer(variant="preact", **size).init_state(
        jax.random.PRNGKey(0))
    jckpt.save_checkpoint(os.path.join(sroot, "Hourglass FT", "parameter"),
                          1, state)
    common = ["--comment", "Hourglass FT", "--variant", "preact",
              "--protocol-out", "SH+FT", "--batch-size", "4",
              "--save-root", sroot, "--n-stacks", "2", "--features", "16",
              "--depth", "2"]
    jax_sh_preprocess.main(common + ["--h36m-dir", theirs])
    sh_preprocess.main(common + ["--h36m-dir", mine] + CPU)
    a, b, gt = _bins(mine, "SH+FT"), _bins(theirs, "SH+FT"), \
        _bins(mine, "GT")
    for task in ("train", "valid"):
        assert a[task].keys() == b[task].keys() == gt[task].keys()
        for key in gt[task]:
            if key == "part":
                continue
            for x, y in zip(a[task][key], gt[task][key]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert len(a[task][key]) == len(gt[task][key])
        pa, pb = np.stack(a[task]["part"]), np.stack(b[task]["part"])
        assert pa.shape == (len(gt[task]["part"]), 17, 2)
        assert pa.dtype == pb.dtype == np.float32
        assert not np.allclose(pa, np.stack(gt[task]["part"]))
        dist = np.linalg.norm(pa - pb, axis=-1)
        cell = 200 * np.asarray(gt[task]["scale"], np.float64)[:, None] / 64
        assert (dist <= 1e-3 * cell).mean() >= 0.95, task
        assert (dist <= cell * (1 + 1e-6)).all(), task


# ------------------------------------------------- the protocol chain


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The five CLIs of the chain, then the four others, each started with
    TF32 switched on; records the two switches as each ``main`` left them."""
    root = tmp_path_factory.mktemp("chain")
    h36m = write_h36m_dataset(str(root / "Human3.6M"), n_train=24, n_valid=8,
                              with_images=True)
    mpii = write_mpii_dataset(str(root / "MPII"), n_train_images=6,
                              n_test_images=1)
    sroot = str(root / "save")
    hg_common = ["--batch-size", "4", "--epochs-per-run", "1",
                 "--steps-per-dispatch", "1", "--save-root", sroot] + TINY
    bl_common = ["--data-dir", h36m, "--protocol", "SH+FT",
                 "--comment", "Bilinear SH+FT", "--save-root", sroot,
                 "--batch-size", "8"]
    flags = {}

    def call(name, main, argv):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            main(argv + CPU)
        finally:
            flags[name] = (torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = True  # torch's defaults

    call("train_hourglass", train_hourglass.main,
         ["--data-dir", mpii] + hg_common)
    call("train_hourglass_ft", train_hourglass_ft.main,
         ["--data-dir", h36m] + hg_common)
    call("sh_preprocess", sh_preprocess.main,
         ["--comment", "Hourglass FT", "--variant", "preact", "--h36m-dir",
          h36m, "--protocol-out", "SH+FT", "--batch-size", "4",
          "--save-root", sroot] + TINY)
    call("train_bilinear", train_bilinear.main,
         bl_common + ["--epochs-per-run", "2"])
    call("valid_bilinear", valid_bilinear.main, bl_common)
    call("valid_hourglass_ft", valid_hourglass_ft.main,
         ["--data-dir", h36m, "--batch-size", "4", "--save-root", sroot]
         + TINY)
    call("valid_hourglass", valid_hourglass.main,
         ["--data-dir", mpii, "--batch-size", "4", "--save-root", sroot]
         + TINY)
    call("eval_hourglass", eval_hourglass.main,
         ["--data-dir", mpii, "--batch-size", "4", "--save-root", sroot]
         + TINY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PoseHTTPServer, "serve_forever",
                   lambda self: (self.start(), self.stop()))
        call("serve", serve.main,
             ["--run-dir", os.path.join(sroot, "Bilinear SH+FT"),
              "--data-dir", h36m, "--protocol", "SH+FT", "--port", "0",
              "--dtype", "float32"])
    return dict(h36m=h36m, sroot=sroot, flags=flags)


def test_sh_ft_protocol_chain(chain):
    """The asserts of the JAX package's test_protocol_chain.py."""
    h36m, sroot = chain["h36m"], chain["sroot"]
    assert os.path.exists(os.path.join(sroot, "Hourglass", "parameter",
                                       "1.save"))
    assert os.path.exists(os.path.join(sroot, "Hourglass FT", "parameter",
                                       "1.save"))
    for task in ("train", "valid"):
        assert os.path.exists(os.path.join(h36m, f"{task}_SH+FT.bin"))
    sh_ft = load_h36m(h36m, Protocol.SH_FT)
    gt = load_h36m(h36m, Protocol.GT)
    assert not np.allclose(sh_ft[Task.Train].raw_part,
                           gt[Task.Train].raw_part)
    np.testing.assert_allclose(sh_ft[Task.Train].raw_s, gt[Task.Train].raw_s)
    assert os.path.exists(os.path.join(sroot, "Bilinear SH+FT", "parameter",
                                       "2.save"))
    with open(os.path.join(sroot, "Bilinear SH+FT", "mpjpe_epoch2.json")) as f:
        metrics = json.load(f)
    assert np.isfinite(metrics["overall"])
    assert metrics["per_action"]


def test_ft_cli_logs_and_evaluates(chain):
    """train_hourglass_ft wrote an FT/loss line and a finite loss;
    valid_hourglass_ft wrote pckh_ft_epoch1.json with 14 joints, hits no
    more than totals, and a finite average."""
    run = os.path.join(chain["sroot"], "Hourglass FT")
    with open(os.path.join(run, "debug.log")) as f:
        log = f.read()
    losses = [float(line.split("loss: ")[1].split(",")[0])
              for line in log.splitlines() if "saved (loss:" in line]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "Fine-tuning hourglass[preact]" in log
    with open(os.path.join(run, "pckh_ft_epoch1.json")) as f:
        res = json.load(f)
    assert res["epoch"] == 1 and np.isfinite(res["avg"])
    assert len(res["per_joint"]) == len(res["hits"]) == 14
    assert all(0 <= h <= t for h, t in zip(res["hits"], res["totals"]))
    assert sum(res["totals"]) == 8 * 14  # every H36M joint is annotated


@pytest.mark.parametrize("cli", [
    "train_hourglass", "train_hourglass_ft", "sh_preprocess",
    "train_bilinear", "valid_bilinear", "valid_hourglass_ft",
    "valid_hourglass", "eval_hourglass", "serve"])
def test_cli_turns_tf32_off(chain, cli):
    assert chain["flags"][cli] == (False, False)


def test_ft_clis_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for main in (train_hourglass_ft.main, valid_hourglass_ft.main,
                 sh_preprocess.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--data-dir", str(tmp_path), "--save-root",
                  str(tmp_path / "save")])
