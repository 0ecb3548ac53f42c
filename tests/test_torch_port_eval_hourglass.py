"""Detector evaluation in the port (bilinear_tpu_torch: ops/decode,
eval/recalibrate, eval/pckh, data/mpii's test rects, eval/mpii_test_export,
the -1.save sentinel, cli/valid_hourglass and cli/eval_hourglass) against
the JAX package on the CPU: a tiny torch7 detector (1 stack, 16 features,
depth 2) with the JAX package's initial weights, on a synthetic MPII tree
written by the port. f32; the fused ResModules run their plain versions.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.data.mpii import MPIIAnnotations as JaxAnnotations
from bilinear_tpu.data.mpii import MPIITestAnnotations as JaxTestAnnotations
from bilinear_tpu.data.pipeline import MPIIHostPipeline as JaxPipeline
from bilinear_tpu.eval import mpii_test_export as jexport
from bilinear_tpu.eval.pckh import evaluate_pckh as jax_evaluate_pckh
from bilinear_tpu.eval.recalibrate import recalibrate as jax_recalibrate
from bilinear_tpu.io import checkpoint as jckpt
from bilinear_tpu.ops import decode as jdecode
from bilinear_tpu.train.hourglass import HourglassTrainer as JaxTrainer
from bilinear_tpu_torch.cli import eval_hourglass, valid_hourglass
from bilinear_tpu_torch.data.h36m import Task
from bilinear_tpu_torch.data.mpii import MPIIAnnotations, MPIITestAnnotations
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.data.synthetic import write_mpii_dataset
from bilinear_tpu_torch.eval import mpii_test_export as pexport
from bilinear_tpu_torch.eval.pckh import evaluate_pckh, pckh_totals
from bilinear_tpu_torch.eval.recalibrate import recalibrate
from bilinear_tpu_torch.io import checkpoint as pckpt
from bilinear_tpu_torch.ops import decode as pdecode
from bilinear_tpu_torch.train.hourglass import HourglassTrainer
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread  # noqa: F401

SIZE = dict(n_stacks=1, features=16, depth=2)
BATCH, CANVAS = 4, 256
ARGS = ["--n-stacks", "1", "--features", "16", "--depth", "2",
        "--batch-size", str(BATCH), "--canvas", str(CANVAS), "--device",
        "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval") / "mpii")
    write_mpii_dataset(root, n_train_images=20, n_test_images=3,
                       learnable=True)
    return root


@pytest.fixture(scope="module")
def jax_side():
    trainer = JaxTrainer(**SIZE)
    state = trainer.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    return trainer, state, params, stats


def _port_model(params, stats, fused=False):
    state = HourglassTrainer(**SIZE, fused_blocks=fused,
                             device="cpu").init_state(1)
    state.model.load_state_dict(wt.hourglass_torch7_from_jax(params, stats))
    return state.model


def _pipes(data, task, jax_too=True):
    port = MPIIHostPipeline(MPIIAnnotations(data, task), BATCH, pad=True,
                            canvas=CANVAS)
    if not jax_too:
        return port
    return port, JaxPipeline(JaxAnnotations(data, task), BATCH, pad=True,
                             canvas=CANVAS)


# --------------------------------------------------------------- decode


def test_decode_matches_jax():
    """argmax indices (the first of equal maxima) and flip_average exactly;
    image space within 1e-6 relative."""
    rng = np.random.RandomState(0)
    hm = rng.rand(3, 16, 64, 64).astype(np.float32)
    hm_f = rng.rand(3, 16, 64, 64).astype(np.float32)
    hm[0, 0, 9, 2] = hm[0, 0, 5, 7] = 2.0  # a tie
    centers = (rng.rand(3, 2) * 300).astype(np.float32)
    scales = (rng.rand(3) * 3 + 0.5).astype(np.float32)

    tie = pdecode.argmax_decode(torch.from_numpy(hm))
    np.testing.assert_array_equal(
        tie.numpy(), np.asarray(jdecode.argmax_decode(jnp.asarray(hm))))
    assert tie[0, 0].tolist() == [7.0, 5.0]
    merged = pdecode.flip_average(torch.from_numpy(hm), torch.from_numpy(hm_f))
    jmerged = jdecode.flip_average(jnp.asarray(hm), jnp.asarray(hm_f))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    pose = pdecode.argmax_decode(merged)
    jpose = jdecode.argmax_decode(jmerged)
    np.testing.assert_array_equal(pose.numpy(), np.asarray(jpose))
    img = pdecode.heatmap_to_image_space(pose, torch.from_numpy(centers),
                                         torch.from_numpy(scales))
    jimg = jdecode.heatmap_to_image_space(jpose, jnp.asarray(centers),
                                          jnp.asarray(scales))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-6)


# ---------------------------------------------------------- recalibrate


@pytest.fixture(scope="module")
def jax_recalibrated(data, jax_side):
    trainer, _, params, stats = jax_side
    _, jpipe = _pipes(data, Task.Train)
    return jax.tree.map(np.asarray, jax_recalibrate(trainer.model, params,
                                                    stats, jpipe))


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_recalibrate_matches_jax(data, jax_side, jax_recalibrated, fused):
    """Reset + cumulative BN over the padded train split, the short last
    batch cut to its real rows: running statistics within 1e-4 relative
    (atol 1e-6) of the JAX package's, batch counts equal; the momenta and
    the model's mode are restored."""
    _, _, params, stats = jax_side
    model = _port_model(params, stats, fused).eval()
    pipe = _pipes(data, Task.Train, jax_too=False)
    n = recalibrate(model, pipe)
    assert n == len(pipe) and len(pipe.annotations) % BATCH  # a short one
    assert not model.training
    assert all(m.momentum == 0.1 for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    _, got = wt.hourglass_torch7_to_jax(model.state_dict())
    paths = jax.tree_util.tree_leaves_with_path(jax_recalibrated)
    mine = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(paths) == len(mine)
    for path, want in paths:
        key = jax.tree_util.keystr(path)
        if key.endswith("['count']"):
            assert int(mine[path]) == int(want) == n, key
        else:
            np.testing.assert_allclose(mine[path], want, rtol=1e-4,
                                       atol=1e-6, err_msg=key)


# ----------------------------------------------------------------- PCKh


@pytest.mark.parametrize("threshold", [0.5, 1.5])
def test_pckh_matches_jax(data, jax_side, jax_recalibrated, threshold):
    """Flip-TTA PCKh per joint equal to the JAX package's on the valid
    split, with the same recalibrated statistics; at threshold 1.5 too, where
    the untrained detector hits some joints and misses others."""
    trainer, _, params, _ = jax_side
    pipe, jpipe = _pipes(data, Task.Valid)
    model = _port_model(params, jax_recalibrated)
    per_joint, avg = evaluate_pckh(model, pipe, threshold)
    jper, javg = jax_evaluate_pckh(
        trainer.model, {"params": params, "batch_stats": jax_recalibrated},
        jpipe, threshold)
    assert list(per_joint) == list(jper)
    for k in jper:
        assert (math.isnan(per_joint[k]) and math.isnan(jper[k])) or \
            per_joint[k] == jper[k], k
    assert avg == javg
    hit, total = pckh_totals(model, pipe, threshold)
    assert total.sum() > 0
    if threshold == 1.5:
        assert 0 < hit.sum() < total.sum()


# --------------------------------------------------------- test export


def test_test_annotations_match_jax(data):
    for subset in (False, True):
        ours = MPIITestAnnotations(data, train_subset=subset)
        theirs = JaxTestAnnotations(data, train_subset=subset)
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours.entries, theirs.entries):
            assert (a.image_name, a.img_idx, a.r_idx, a.scale, a.head) == \
                (b.image_name, b.img_idx, b.r_idx, b.scale, b.head)
            np.testing.assert_array_equal(a.center, b.center)
            np.testing.assert_array_equal(a.keypoints, b.keypoints)
            np.testing.assert_array_equal(a.valid, b.valid)


def _read_poses(d):
    return {f: np.loadtxt(os.path.join(d, f)) for f in sorted(os.listdir(d))}


def test_export_and_convert_match_jax(tmp_path, data, jax_side):
    """One .txt per test rect with the JAX exporter's names and poses
    within 1e-3 px (original-image pixels); the converter's count equal to
    the JAX converter's on the same predictions."""
    trainer, _, params, stats = jax_side
    annotations = MPIITestAnnotations(data)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    n = pexport.export_predictions(_port_model(params, stats), annotations,
                                   ours, batch_size=BATCH, canvas=CANVAS)
    jn = jexport.export_predictions(
        trainer.model, {"params": params, "batch_stats": stats},
        JaxTestAnnotations(data), theirs, batch_size=BATCH, canvas=CANVAS)
    assert n == jn == len(annotations)
    a, b = _read_poses(ours), _read_poses(theirs)
    assert list(a) == list(b)
    for f in a:
        assert a[f].shape == (16, 3)
        np.testing.assert_array_equal(a[f][:, 0], np.arange(16))
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=1e-3, err_msg=f)
    mat = str(tmp_path / "pred.mat")
    count = pexport.convert_predictions(data, ours, mat)
    assert count == jexport.convert_predictions(
        data, ours, str(tmp_path / "jpred.mat")) == n
    import scipy.io

    assert "pred" in scipy.io.loadmat(mat)


# ------------------------------------------------------ sentinel + CLIs


def test_finalized_sentinel(tmp_path, jax_side):
    """``-1.save``: never the newest epoch, loaded by its epoch; a JAX one
    restores in the port's TrainState."""
    _, state, _, _ = jax_side
    pdir = str(tmp_path / "parameter")
    jckpt.save_checkpoint(pdir, 2, state)
    assert not pckpt.is_finalized(pdir)
    jckpt.mark_finalized(pdir, state)
    assert pckpt.is_finalized(pdir) and pckpt.latest_epoch(pdir) == 2
    port = HourglassTrainer(**SIZE, device="cpu").init_state(3)
    port.restore(pckpt.load_checkpoint(pdir, pckpt.FINALIZED_EPOCH))
    params, stats, _ = port.trees()
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    pdir2 = str(tmp_path / "port")
    pckpt.mark_finalized(pdir2, params, stats, step=5)
    assert pckpt.is_finalized(pdir2)
    assert pckpt.latest_epoch(pdir2) == jckpt.latest_epoch(pdir2)
    assert jckpt.load_checkpoint(pdir2, -1)["epoch"] == -1


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, jax_side):
    """A run whose 1.save the JAX package wrote."""
    root = tmp_path_factory.mktemp("run")
    jckpt.save_checkpoint(str(root / "save" / "tiny" / "parameter"), 1,
                          jax_side[1])
    return root


def test_valid_hourglass_cli(run_dir, data):
    argv = ARGS + ["--data-dir", data, "--save-root",
                   str(run_dir / "save"), "--comment", "tiny"]
    valid_hourglass.main(argv + ["--fused-blocks", "true"])
    with open(run_dir / "save" / "tiny" / "pckh_epoch1.json") as f:
        fused = json.load(f)
    valid_hourglass.main(argv)
    with open(run_dir / "save" / "tiny" / "pckh_epoch1.json") as f:
        standard = json.load(f)
    assert fused["epoch"] == 1 and len(fused["per_joint"]) == 14
    assert sum(standard["totals"]) > 0
    assert np.abs(np.subtract(fused["hits"], standard["hits"])).max() <= 1
    assert fused["totals"] == standard["totals"]


def test_eval_hourglass_cli_writes_then_reuses_the_sentinel(run_dir, data):
    argv = ARGS + ["--data-dir", data, "--save-root",
                   str(run_dir / "save"), "--comment", "tiny"]
    run = run_dir / "save" / "tiny"
    eval_hourglass.main(argv)
    assert pckpt.is_finalized(str(run / "parameter"))
    first = pckpt.load_checkpoint(str(run / "parameter"), -1)
    eval_hourglass.main(argv)
    log = (run / "debug.log").read_text()
    assert log.count("Finalizing BN statistics") == 1
    assert log.count("Using finalized BN statistics (-1.save)") == 1
    again = pckpt.load_checkpoint(str(run / "parameter"), -1)
    assert os.path.getmtime(run / "parameter" / "-1.save") > 0
    for a, b in zip(jax.tree.leaves(first["state"]),
                    jax.tree.leaves(again["state"])):
        np.testing.assert_array_equal(a, b)
    n = len(MPIITestAnnotations(data))
    assert len(os.listdir(run / "prediction")) == n
    assert f"Converter injected {n} rects" in log
    assert (run / "pred_keypoints_mpii.mat").exists()


@pytest.mark.parametrize("cli", [valid_hourglass, eval_hourglass],
                         ids=["valid_hourglass", "eval_hourglass"])
def test_cli_without_a_card_raises(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--data-dir", str(tmp_path), "--save-root",
                  str(tmp_path / "save")])
