"""The port's AOT export (bilinear_tpu_torch/io/aot.py, cli/export_aot.py,
``cli/serve.py --aot``) and its torch export (cli/export_torch.py) on the
CPU, against the JAX package's io/aot.py artifacts and
utils/torch_compat.py::save_reference_* on the same weights.

Tolerances, each measured before it was set, on 300 rows, in mm relative
to mean|ref|: the port's lifting artifact against JAX's (both run the
plain path: the port's ``BilinearUnit``, JAX's flax module). bf16: the two
bf16 chains round apart at every layer, so neither is held to the other's
bits: the port's answers are no farther from JAX's f32 artifact than 1.5x
JAX's own bf16 artifact is, in mean and max (measured 1.14x / 0.99x; the
two bf16 artifacts sit 6.1e-3 / 4.1e-2 apart). int8-static: the same four
scales, so only a value at a rounding boundary of the bf16 encode moves one
int8 step: mean below 1e-4, max below 2e-2 (measured 8.6e-6 / 6.2e-3; 19%
of the answers bit-equal). The End2End artifact is the in-process plain
path (End2EndServer on the standard detector) bit for bit on the CPU.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.core.state import TrainState as JaxTrainState
from bilinear_tpu.io import aot as jaot
from bilinear_tpu.io import checkpoint as jckpt
from bilinear_tpu.io.aot import AOTPose as JaxAOTPose
from bilinear_tpu.train.bilinear import BilinearTrainer as JaxBilinear
from bilinear_tpu.train.hourglass import HourglassTrainer as JaxHourglass
from bilinear_tpu.utils import torch_compat
from bilinear_tpu_torch.cli import export_aot, export_torch, serve
from bilinear_tpu_torch.client import PoseClient
from bilinear_tpu_torch.data.h36m import Task, load_h36m
from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
from bilinear_tpu_torch.io import aot
from bilinear_tpu_torch.io.checkpoint import save_checkpoint
from bilinear_tpu_torch.models.bilinear import BilinearUnit
from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.serving import End2EndServer
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread, scramble_bn

SIZE = dict(n_stacks=1, features=16, depth=1)
SIZE_FLAGS = ["--n-stacks", "1", "--features", "16", "--depth", "1"]


def _scrambled(params, stats, seed):
    scramble = scramble_bn(np.random.RandomState(seed))
    return (jax.tree_util.tree_map_with_path(scramble, params),
            jax.tree_util.tree_map_with_path(scramble, stats))


def _lifting_tree(seed):
    return _scrambled(*wt.bilinear_to_jax(BilinearUnit(
        generator=torch.Generator().manual_seed(seed)).state_dict()), seed)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An H36M tree, a lifting run (epoch 3) and an End2End run (epoch 2),
    and their artifacts written by cli.export_aot on the CPU."""
    root = tmp_path_factory.mktemp("aot")
    data = write_h36m_dataset(str(root / "Human3.6M"), n_train=64,
                              n_valid=8)
    lift_run, e2e_run = str(root / "lift"), str(root / "e2e")
    lift = _lifting_tree(0)
    save_checkpoint(os.path.join(lift_run, "parameter"), 3, *lift)
    e2e = _scrambled(*wt.end2end_to_jax(End2End(
        **SIZE, generator=torch.Generator().manual_seed(1)).state_dict(),
        "torch7"), 1)
    save_checkpoint(os.path.join(e2e_run, "parameter"), 2, *e2e)
    common = ["--data-dir", data, "--device", "cpu"]
    out = {}
    for tag, argv in (
            ("bf16", ["--kind", "lifting", "--run-dir", lift_run]),
            ("int8-static", ["--kind", "lifting", "--run-dir", lift_run,
                             "--quantize", "int8-static"]),
            ("end2end", ["--kind", "end2end", "--run-dir", e2e_run,
                         "--dtype", "float32", "--batch-sizes", "2", "8"]
             + SIZE_FLAGS)):
        out[tag] = str(root / f"{tag}.aot")
        export_aot.main(common + argv + ["--out", out[tag]])
    return dict(data=data, train=load_h36m(data)[Task.Train], lift=lift,
                e2e=e2e, paths=out, root=root)


@pytest.mark.parametrize("quantize", ["bf16", "int8-static"])
def test_lifting_artifact_matches_jax(runs, quantize):
    """The port's symbolic-batch artifact (loaded in this process from its
    file) against JAX's own io/aot.py artifact of the same weights and
    statistics; the one program takes 300, 7 and 1 rows."""
    train = runs["train"]
    q = None if quantize == "bf16" else quantize

    def jax_artifact(dtype, tag):
        path = str(runs["root"] / f"jax_{tag}.aot")
        jaot.save_artifact(path, "lifting", jaot.export_lifting(
            *runs["lift"], train.mean_part, train.std_part, train.mean_s,
            train.std_s, dtype=dtype, quantize=q, calib_sample=train.part))
        return jaot.load_artifact(path)

    ref_pose = jax_artifact(jnp.bfloat16, quantize)
    f32_pose = jax_artifact(jnp.float32, "f32") if q is None else None
    pose = aot.load_artifact(runs["paths"][quantize])
    man = pose.manifest
    assert man["format"] == aot.FORMAT and man["kind"] == "lifting"
    assert man["epoch"] == 3 and man["device"] == "cpu"
    assert man["quantize"] == q and list(man["programs"]) == ["sym"]
    assert man["torch_version"] == torch.__version__
    rs = np.random.RandomState(2)
    kp = (train.mean_part + train.std_part * rs.randn(300, 32)).astype(
        np.float32).reshape(300, 16, 2)
    got, ref = pose(kp), ref_pose(kp)
    assert got.shape == ref.shape == (300, 16, 3)
    scale = np.abs(ref).mean()
    for n in (1, 7):  # the one symbolic program at other sizes (the f32
        # GEMM's blocking, so its sum order, follows the row count)
        assert np.abs(pose(kp[:n]) - got[:n]).max() < 1e-5 * scale
    if q is None:
        f32 = f32_pose(kp)
        mine, theirs = np.abs(got - f32), np.abs(ref - f32)
        assert mine.mean() <= 1.5 * theirs.mean()
        assert mine.max() <= 1.5 * theirs.max()
    else:
        d = np.abs(got - ref)
        assert d.mean() < 1e-4 * scale and d.max() < 2e-2 * scale


def test_end2end_artifact_chunks_pads_and_matches_the_plain_path(runs):
    """b2/b8 (b1 would never pad: every remainder fits 1-frame chunks): 3
    frames run as 2 + 1 padded to 2, 9 as 8 + 1 padded to 2, JAX's greedy
    plan; the answers are End2EndServer's on the standard detector (same
    sizes, f32) bit for bit, u8 frames those of f32 / 255."""
    pose = aot.load_artifact(runs["paths"]["end2end"])
    assert pose.batch_sizes == (2, 8) and pose.kind == "end2end"
    assert set(pose.manifest["programs"]) == {"b2", "b8"}
    ns = JaxAOTPose({"kind": "end2end"}, {"b2": None, "b8": None})
    train = runs["train"]
    server = End2EndServer(
        {"params": runs["e2e"][0], "batch_stats": runs["e2e"][1]},
        train.mean_part, train.std_part, train.mean_s, train.std_s,
        dtype=torch.float32, batch_sizes=(2, 8), model_kw=SIZE,
        device="cpu")
    rs = np.random.RandomState(3)
    for n in (3, 9):
        assert pose._chunks(n) == ns._chunks(n) == server._chunks(n)
        assert pose._chunks(n)[-1] == (1, 2)
        u8 = rs.randint(0, 256, (n, 256, 256, 3)).astype(np.uint8)
        centers = (rs.rand(n, 2) * 40 + 108).astype(np.float32)
        scales = (rs.rand(n) + 1.0).astype(np.float32)
        got = pose(u8, centers, scales)
        want = server.predict(u8.astype(np.float32) / np.float32(255),
                              centers, scales)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    with pytest.raises(SystemExit, match="lifting only"):
        export_aot.main(["--kind", "end2end", "--quantize", "int8-static",
                         "--run-dir", "x", "--data-dir", runs["data"],
                         "--out", "y", "--device", "cpu"])


def test_aot_server_hot_swaps_a_replaced_artifact(runs, tmp_path):
    """AOTServer reloads when the file is replaced (save_artifact renames
    over it), with the new epoch and new answers, and not otherwise."""
    path = str(tmp_path / "live.aot")
    shutil.copy(runs["paths"]["bf16"], path)
    server = aot.AOTServer(path)
    kp = np.zeros((4, 16, 2), np.float32) + runs["train"].mean_part.reshape(
        16, 2)
    before = server.lift(kp)
    assert isinstance(before, torch.Tensor) and server.epoch == 3
    assert not server.reload()
    train = runs["train"]
    stats = (train.mean_part, train.std_part, train.mean_s, train.std_s)
    aot.save_artifact(path, "lifting", aot.export_lifting(
        *_lifting_tree(5), *stats, device="cpu"), {"epoch": 4})
    assert server.reload() and server.epoch == 4
    assert not np.allclose(server.lift(kp).numpy(), before.numpy())
    assert not server.reload()
    assert server.warm([1, 3]) == [1, 3]


def test_serve_aot_daemon_answers_both_routes(runs):
    """serve --aot with one artifact of each kind: /v1/lift and /v1/pose
    answer through a client, with the artifacts' epochs; a second artifact
    of one kind is refused."""
    paths = runs["paths"]
    args = serve.build_parser().parse_args(
        ["--aot", paths["int8-static"], paths["end2end"], "--port", "0"])
    http = serve.build_server(args)
    http.start()
    try:
        client = PoseClient(f"http://{http.host}:{http.port}")
        health = client.health()
        assert health["lift"]["epoch"] == 3 and health["pose"]["epoch"] == 2
        kp = np.zeros((5, 16, 2), np.float32)
        np.testing.assert_array_equal(
            client.lift(kp), aot.load_artifact(paths["int8-static"])(kp))
        p2, p3 = client.pose(np.zeros((3, 256, 256, 3), np.uint8))
        assert p2.shape == (3, 16, 2) and np.isfinite(p3).all()
    finally:
        http.stop()
    args = serve.build_parser().parse_args(
        ["--aot", paths["bf16"], paths["int8-static"]])
    with pytest.raises(ValueError, match="two 'lifting' artifacts"):
        serve.build_server(args)
    with pytest.raises(SystemExit):
        serve.main(["--port", "0"])  # neither --aot nor a run dir


FAMILIES = {
    "bilinear": (lambda: JaxBilinear().tx, "Bilinear GT",
                 torch_compat.save_reference_bilinear_checkpoint, 1e-3),
    "hourglass": (lambda: JaxHourglass().tx, "Hourglass",
                  lambda p, s, e, lr: torch_compat.
                  save_reference_hourglass_checkpoint(p, s, e, "torch7", lr),
                  2.5e-4),
    "hourglass_ft": (lambda: JaxHourglass(variant="preact").tx,
                     "Hourglass FT",
                     lambda p, s, e, lr: torch_compat.
                     save_reference_hourglass_checkpoint(p, s, e, "preact",
                                                         lr), 2.5e-4),
}


def _family_tree(family):
    if family == "bilinear":
        return _lifting_tree(6)
    from bilinear_tpu_torch.models.detectors import make_model

    variant = "torch7" if family == "hourglass" else "preact"
    model = make_model(variant, generator=torch.Generator().manual_seed(7),
                       n_stacks=2, features=16, depth=2)
    return _scrambled(*wt.HOURGLASS[variant].to_jax(model.state_dict()), 7)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_torch_matches_jax_key_by_key(family, tmp_path):
    """cli.export_torch on a run whose checkpoint has non-zero optimizer
    moments against JAX's save_reference_* on the same TrainState: the
    same epoch, step, state_dict (every key, type and value, the identity
    ResModules' zero conv_skip included) and optimizer state (parameter
    ids, step, moments, param_groups)."""
    tx_of, comment, save_ref, lr = FAMILIES[family]
    params, stats = _family_tree(family)
    rs = np.random.RandomState(8)
    state = JaxTrainState.create(params, stats, tx_of())
    state = state.replace(step=jnp.asarray(11, jnp.int32), opt_state=jax.tree.map(
        lambda a: (np.asarray(rs.rand(*a.shape), np.float32)
                   if np.issubdtype(np.asarray(a).dtype, np.floating)
                   else np.asarray(10, np.asarray(a).dtype)),
        state.opt_state))
    run = tmp_path / "save" / comment
    jckpt.save_checkpoint(str(run / "parameter"), 5, state)
    ref_path = str(tmp_path / "ref.save")
    save_ref(ref_path, state, 5, lr)
    export_torch.main(["--family", family, "--save-root",
                       str(tmp_path / "save")])
    got = torch.load(str(run / "torch_export" / "5.save"), weights_only=False)
    want = torch.load(ref_path, weights_only=False)
    assert got.keys() == want.keys()
    assert got["epoch"] == want["epoch"] == 5
    assert got["step"] == want["step"] == 11
    assert list(got["state"]) == list(want["state"])
    for k, v in want["state"].items():
        assert got["state"][k].dtype == v.dtype, k
        assert torch.equal(got["state"][k], v), k
    go, wo = got["optimizer"], want["optimizer"]
    assert go["param_groups"] == wo["param_groups"]
    assert go["state"].keys() == wo["state"].keys()
    for pid, entry in wo["state"].items():
        assert go["state"][pid].keys() == entry.keys(), pid
        for name, t in entry.items():
            assert torch.equal(go["state"][pid][name], t), (pid, name)
