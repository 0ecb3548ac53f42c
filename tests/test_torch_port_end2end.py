"""The port's End2End (bilinear_tpu_torch/models/end2end.py, ops/decode.py,
serving.py::End2EndServer, the /v1/pose route, client.pose, cli/webcam.py)
against the JAX package on the CPU, at a tiny size (2 stacks, 16 features,
depth 2; the lifting half at its full width), weights carried by
end2end_from_jax.

Tolerances (f32 on both sides): softargmax coordinates 1e-3 heatmap cells
(measured 1.2e-4: the marginal sums, taken in another order, are scaled by
10 before the exp, which turns an ulp of the sum into ~1e-5 of a weight);
the eval forward's
heatmaps 1e-4 of max|ref| (as the detector tests), pose_img 1e-3 px and the
normalized 3D pose 1e-4 of max|ref| (the decode and BilinearUnit add a few
ulps to the heatmaps' gap). The decode box (centres, scales) is never the
crop's full-frame box, so a port that decoded with another box fails.
"""
import io
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.cli import webcam as jwebcam
from bilinear_tpu.ops import decode as jdecode
from bilinear_tpu.serving import End2EndServer as JaxEnd2EndServer
from bilinear_tpu_torch.cli import webcam
from bilinear_tpu_torch.client import PoseClient, ServerError
from bilinear_tpu_torch.data.h36m import Task, load_h36m
from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
from bilinear_tpu_torch.io.checkpoint import save_checkpoint
from bilinear_tpu_torch.models.end2end import End2End, assemble_variables
from bilinear_tpu_torch.ops import decode
from bilinear_tpu_torch.serving import End2EndServer
from bilinear_tpu_torch.serving_http import PoseHTTPServer, coerce_frames
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import (NoDropoutEnd2End, one_torch_thread,
                                 scramble_bn)

SIZE = dict(n_stacks=2, features=16, depth=2)
VARIANTS = ("torch7", "preact")


@pytest.fixture(scope="module")
def h36m(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("e2e") / "Human3.6M")
    write_h36m_dataset(root, n_train=4, n_valid=2, with_images=True)
    return root, load_h36m(root)[Task.Train]


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, 256, 256, 3).astype(
        np.float32)


# Decode boxes in original-image space, away from the full frame.
CENTERS = np.asarray([[412.5, 301.0], [530.0, 455.5], [388.0, 512.0]],
                     np.float32)
SCALES = np.asarray([2.7, 3.4, 2.2], np.float32)
CELL_PX = 200 * float(SCALES.max()) / 64  # one heatmap cell, in pixels


# ------------------------------------------------------------- decode


def test_softargmax_matches_jax():
    rng = np.random.RandomState(0)
    hm = rng.rand(3, 16, 64, 64).astype(np.float32) * 0.2
    hm[0, 3, 10, 50] += 2.0  # one peaked joint
    got = decode.softargmax(torch.from_numpy(hm)).numpy()
    ref = np.asarray(jdecode.softargmax(jnp.asarray(hm)))
    assert got.shape == (3, 16, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[0, 3], [50.0, 10.0], atol=0.05)


def test_softargmax_of_garbage_heatmaps_is_finite():
    """Heatmaps of magnitude 1e7 (the clip before exp): finite in both
    packages and within 1e-3 cells of each other."""
    rng = np.random.RandomState(1)
    hm = (rng.randn(2, 16, 64, 64) * 1e7).astype(np.float32)
    got = decode.softargmax(torch.from_numpy(hm))
    ref = np.asarray(jdecode.softargmax(jnp.asarray(hm)))
    assert torch.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)
    g = torch.from_numpy(hm).requires_grad_()
    decode.softargmax(g).sum().backward()
    assert torch.isfinite(g.grad).all()


def test_decode_to_normalized_matches_jax(h36m):
    _, train = h36m
    rng = np.random.RandomState(2)
    heat = rng.rand(3, 64, 64, 16).astype(np.float32)  # (B, H, W, J)
    args = (CENTERS, SCALES, train.mean_part, train.std_part)
    pose, norm = decode.decode_to_normalized(
        torch.from_numpy(heat), *(torch.from_numpy(a) for a in args))
    jpose, jnorm = jdecode.decode_to_normalized(
        jnp.asarray(heat), *(jnp.asarray(a) for a in args))
    assert pose.shape == (3, 16, 2) and norm.shape == (3, 32)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), rtol=0,
                               atol=1e-3 * CELL_PX)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jnorm)).max())


# ------------------------------------------------------------- model


def _jax_vars(variant, seed=0):
    """JAX End2End trees: a seeded port initialisation carried over by
    end2end_to_jax (flax's own init costs ~20 s of eager compiles on the
    CPU; test_weights_round_trip_exactly_both_ways holds the trees to its
    structure), every BN scrambled from a numpy seed."""
    model = End2End(variant=variant, **SIZE,
                    generator=torch.Generator().manual_seed(seed))
    params, stats = wt.end2end_to_jax(model.state_dict(), variant)
    scramble = scramble_bn(np.random.RandomState(seed))
    return (jax.tree_util.tree_map_with_path(scramble, params),
            jax.tree_util.tree_map_with_path(scramble, stats))


@pytest.fixture(scope="module", params=VARIANTS)
def jax_vars(request):
    return (request.param,) + _jax_vars(request.param)


def _port(variant, params, stats, **kw):
    model = End2End(variant=variant, **SIZE, **kw)
    model.load_state_dict(wt.end2end_from_jax(params, stats, variant))
    return model


def test_weights_round_trip_exactly_both_ways(jax_vars):
    """end2end_to_jax gives the JAX module's own tree (structure, shapes and
    types of flax's init), and the two converters are exact inverses."""
    variant, params, stats = jax_vars
    ref = jax.eval_shape(lambda key: NoDropoutEnd2End(
        variant=variant, **SIZE).init(
            key, jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2)),
            jnp.ones((1,)), jnp.zeros(32), jnp.ones(32), train=False),
        jax.random.PRNGKey(0))
    for got, want in ((params, ref["params"]), (stats, ref["batch_stats"])):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype
    sd = wt.end2end_from_jax(params, stats, variant)
    assert sd.keys() == End2End(variant=variant, **SIZE).state_dict().keys()
    p2, s2 = wt.end2end_to_jax(sd, variant)
    for a, b in ((p2, params), (s2, stats)):
        la = jax.tree_util.tree_leaves_with_path(a)
        lb = dict(jax.tree_util.tree_leaves_with_path(b))
        assert len(la) == len(lb)
        for path, leaf in la:
            np.testing.assert_array_equal(leaf, np.asarray(lb[path]))
    other = "preact" if variant == "torch7" else "torch7"
    with pytest.raises(ValueError, match=f"not '{other}'"):
        wt.end2end_from_jax(params, stats, other)


def test_eval_forward_matches_jax(jax_vars, h36m):
    variant, params, stats = jax_vars
    _, train = h36m
    x = _images(3, 3)[:, ::2, ::2]  # 128 x 128: a third of the JAX time
    args = (CENTERS, SCALES, train.mean_part, train.std_part)
    hm, pose, p3 = jax.jit(NoDropoutEnd2End(variant=variant, **SIZE).apply,
                           static_argnames="train")(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        *(jnp.asarray(a) for a in args), train=False)
    model = _port(variant, params, stats).eval()
    with torch.no_grad():
        ghm, gpose, gp3 = model(torch.from_numpy(x.copy()),
                                *(torch.from_numpy(a) for a in args))
    hm, pose, p3 = (np.asarray(a) for a in (hm, pose, p3))
    assert ghm.shape == hm.shape == (2, 3, 32, 32, 16)
    assert np.abs(ghm.numpy() - hm).max() <= 1e-4 * np.abs(hm).max()
    np.testing.assert_allclose(gpose.numpy(), pose, rtol=0,
                               atol=1e-3 * CELL_PX)
    assert np.abs(gp3.numpy() - p3).max() <= 1e-4 * np.abs(p3).max()
    # The decode box matters: the full-frame box gives another pose.
    with torch.no_grad():
        _, full, _ = model(torch.from_numpy(x.copy()),
                           torch.full((3, 2), 128.0),
                           torch.full((3,), 256 / 200),
                           *(torch.from_numpy(a) for a in args[2:]))
    assert np.abs(full.numpy() - pose).min() > 1.0


def test_assemble_variables_and_refusals():
    det = End2End(**SIZE).hourglass.state_dict()
    lift = End2End(**SIZE).bilinear.state_dict()
    model = End2End(**SIZE)
    model.load_state_dict(assemble_variables(det, lift))
    assert torch.equal(model.hourglass.htmapArray[0].weight,
                       det["htmapArray.0.weight"])
    int8_model = End2End(quantize="int8", **SIZE)
    assert int8_model.hourglass.hgArray[0].res1[0].quantize == "int8"
    assert int8_model.state_dict().keys() == model.state_dict().keys()
    with pytest.raises(ValueError, match="unsupported quantize"):
        End2End(quantize="int4", **SIZE)
    with pytest.raises(ValueError, match="torch7 variant only"):
        End2End(variant="preact", fused=True, **SIZE)


# ------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port End2End (torch7) checkpoint at epoch 1 and another at 2."""
    d = str(tmp_path_factory.mktemp("e2e_run"))
    for epoch, seed in ((1, 0), (2, 1)):
        params, stats = _jax_vars("torch7", seed)
        save_checkpoint(os.path.join(d, "staged"), epoch, params, stats)
    os.makedirs(os.path.join(d, "parameter"))
    os.link(os.path.join(d, "staged", "1.save"),
            os.path.join(d, "parameter", "1.save"))
    return d


def _server(run_dir, train, **kw):
    return End2EndServer.from_run_dir(run_dir, train, variant="torch7",
                                      model_kw=SIZE, dtype=torch.float32,
                                      device="cpu", **kw)


def test_chunks_match_jax(run_dir, h36m):
    server = _server(run_dir, h36m[1])
    for sizes in ((1, 8, 16), (4,), (2, 5)):
        server.batch_sizes = sizes
        ns = types.SimpleNamespace(batch_sizes=sizes)
        for n in (1, 3, 7, 8, 9, 16, 21, 40):
            assert server._chunks(n) == JaxEnd2EndServer._chunks(ns, n)


def test_predict_pads_and_rescales_u8(run_dir, h36m):
    """21 frames run as 16 + 5 (padded to 8); each frame's answer is the
    model's on that frame alone, within 1e-5 of max|ref| (another batch
    size sums in another order); u8 frames answer exactly as f32 / 255;
    pose3d is the normalized output x std_s + mean_s, in mm."""
    _, train = h36m
    server = _server(run_dir, train)
    u8 = np.random.RandomState(4).randint(0, 256, (21, 256, 256, 3),
                                          dtype=np.uint8)
    f32 = u8.astype(np.float32) / np.float32(255.0)
    p2, p3 = server.predict(u8)
    q2, q3 = server.predict(f32)
    assert p2.shape == (21, 16, 2) and p3.shape == (21, 16, 3)
    np.testing.assert_array_equal(p2, q2)
    np.testing.assert_array_equal(p3, q3)
    with torch.no_grad():
        _, r2, r3 = server._model(
            torch.from_numpy(f32[[0, 20]]), torch.full((2, 2), 128.0),
            torch.full((2,), 256 / 200), server._mean_part,
            server._std_part)
    mm = r3.numpy() * train.std_s + train.mean_s
    assert np.abs(p2[[0, 20]] - r2.numpy()).max() <= 1e-5 * 256
    assert np.abs(p3[[0, 20]].reshape(2, 48) - mm).max() <= \
        1e-5 * np.abs(mm).max()


def test_reload_publishes_a_new_model_between_calls(run_dir, h36m):
    """A reload during a call (here: between its two chunks) answers the
    whole call on the old weights, never loads into the module the call
    runs on, and the next call runs on epoch 2."""
    _, train = h36m
    server = _server(run_dir, train)
    frames = _images(9, 5)  # chunks of 8 and 1
    before, _ = server.predict(frames)
    old = server._model
    old_weights = {k: v.clone() for k, v in old.state_dict().items()}
    staged = os.path.join(run_dir, "staged", "2.save")
    landed = os.path.join(run_dir, "parameter", "2.save")
    real_forward = old.forward
    calls = []

    def forward(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            os.link(staged, landed)
            assert server.reload() and server.epoch == 2
        return real_forward(*a, **k)

    old.forward = forward
    try:
        during, _ = server.predict(frames)
    finally:
        del old.forward
        os.remove(landed)
    assert len(calls) == 2
    np.testing.assert_array_equal(during, before)
    for k, v in old.state_dict().items():
        assert torch.equal(v, old_weights[k]), k
    after, _ = server.predict(frames)
    assert server._model is not old
    assert not np.allclose(after, before)


def test_warm_and_refusals(run_dir, h36m, tmp_path):
    _, train = h36m
    server = _server(run_dir, train, batch_sizes=(1, 2))
    assert server.warm(("u8", "float32")) == [
        (1, "uint8"), (2, "uint8"), (1, "float32"), (2, "float32")]
    for bad in (("bfloat16",), ("uint8", "f16")):
        with pytest.raises(ValueError, match="unknown frame dtype"):
            server.warm(bad)
    with pytest.raises(FileNotFoundError, match="refusing to serve"):
        End2EndServer.from_run_dir(str(tmp_path), train, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            End2EndServer.from_run_dir(run_dir, train, model_kw=SIZE)
    with pytest.raises(ValueError, match="unsupported quantize"):
        _server(run_dir, train, quantize="int8-static")
    with pytest.raises(ValueError, match="do not divide the mesh's data"):
        _server(run_dir, train, batch_sizes=(1, 2), mesh=["cpu"] * 2)


def test_coerce_frames_matches_the_device_rescale():
    u8 = np.random.RandomState(6).randint(0, 256, (2, 4, 4, 3),
                                          dtype=np.uint8)
    f = np.random.RandomState(7).rand(1, 4, 4, 3).astype(np.float32)
    same = coerce_frames([u8, u8])
    assert all(a.dtype == np.uint8 for a in same)
    mixed = coerce_frames([u8, f])
    assert all(a.dtype == np.float32 for a in mixed)
    dev = torch.from_numpy(u8).float() / torch.tensor(255.0)
    np.testing.assert_array_equal(mixed[0], dev.numpy())
    np.testing.assert_array_equal(mixed[1], f)


def test_pose_route_and_client(run_dir, h36m):
    """/v1/pose through PoseHTTPServer and client.pose: answers equal to
    End2EndServer.predict's, a mixed u8/f32 pair coalesced into one
    dispatch, 400 for a malformed body, 404 on the lifting route without a
    lifting model, the pose route in /healthz and /metrics, and a hot
    reload through /admin/reload."""
    _, train = h36m
    server = _server(run_dir, train)
    http = PoseHTTPServer(end2end=server, max_delay_ms=200.0)
    http.start()
    staged = os.path.join(run_dir, "staged", "2.save")
    landed = os.path.join(run_dir, "parameter", "2.save")
    try:
        client = PoseClient(f"http://{http.host}:{http.port}")
        u8 = np.random.RandomState(8).randint(0, 256, (3, 256, 256, 3),
                                              dtype=np.uint8)
        p2, p3 = client.pose(u8, CENTERS, SCALES)
        w2, w3 = server.predict(u8, CENTERS, SCALES)
        np.testing.assert_array_equal(p2, w2)
        np.testing.assert_array_equal(p3, w3)

        f32 = _images(2, 9)
        out = {}

        def ask(key, frames):
            out[key] = client.pose(frames)

        threads = [threading.Thread(target=ask, args=a)
                   for a in (("u8", u8), ("f32", f32))]
        before = http.pose_batcher.batches_dispatched
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert http.pose_batcher.batches_dispatched - before == 1
        for key, frames in (("u8", u8), ("f32", f32)):
            ref = server.predict(frames)
            for a, b in zip(out[key], ref):
                assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()

        for body in (b"", _npz(frames=np.zeros((2, 64, 64, 3), np.uint8)),
                     _npz(frames=u8, scales=np.ones(2, np.float32))):
            with pytest.raises(ServerError) as e:
                client._request("/v1/pose", body, "application/x-npz",
                                method="POST")
            assert e.value.status == 400
        with pytest.raises(ServerError) as e:
            client.lift(np.zeros((1, 16, 2), np.float32))
        assert e.value.status == 404

        health = client.health()
        assert health["lift"] is None and health["pose"]["epoch"] == 1
        assert health["pose"]["rows"] == 8
        metrics, _ = client._request("/metrics")
        assert b'bilinear_model_epoch{route="pose"} 1' in metrics
        assert b'route="lift"' not in metrics
        os.link(staged, landed)
        assert client.reload() == {"reloaded": True, "epoch": 2,
                                   "lift_epoch": None}
        assert not np.allclose(client.pose(u8, CENTERS, SCALES)[1], p3)
    finally:
        http.stop()
        if os.path.exists(landed):
            os.remove(landed)
    with pytest.raises(ValueError, match="at least one"):
        PoseHTTPServer()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


# ------------------------------------------------------------- webcam


def test_webcam_frames_and_overlay_are_byte_equal_to_jax():
    mine = list(webcam.synthetic_frames(3))
    ref = list(jwebcam.synthetic_frames(3))
    assert len(mine) == 3
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pose = np.random.RandomState(10).rand(16, 2).astype(np.float32) * 300
    pose[0] = (-5.0, 20.0)  # off the frame: skipped by both
    np.testing.assert_array_equal(webcam.draw_keypoints(mine[1], pose),
                                  jwebcam.draw_keypoints(ref[1], pose))


def test_webcam_cli_on_the_cpu(run_dir, tmp_path, capsys):
    """--synthetic --frames 3 --out-dir at the small size: three PNGs from
    the newest checkpoint of the run dir; TF32 turned off."""
    root, comment = os.path.split(run_dir)
    out = str(tmp_path / "frames")
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    webcam.main(["--synthetic", "--frames", "3", "--out-dir", out,
                 "--save-root", root, "--comment", comment,
                 "--n-stacks", "2", "--features", "16", "--depth", "2",
                 "--device", "cpu"])
    assert sorted(os.listdir(out)) == [f"frame_{i:04d}.png"
                                       for i in range(3)]
    assert "End2End forward ready (epoch 1)" in capsys.readouterr().out
    assert not torch.backends.cudnn.allow_tf32
