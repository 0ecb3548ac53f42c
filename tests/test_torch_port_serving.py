"""Port serving slice on the CPU (plain paths): LiftingServer.from_run_dir on
a checkpoint the JAX trainer saved, hot reload, the HTTP daemon, the client
and the CLI, held against the JAX package's LiftingServer."""
import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.data.h36m import Protocol, Task, load_h36m
from bilinear_tpu.data.synthetic import write_h36m_dataset
from bilinear_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from bilinear_tpu.serving import LiftingServer as JaxLiftingServer
from bilinear_tpu.train.bilinear import BilinearTrainer
from bilinear_tpu_torch.cli import serve as pserve
from bilinear_tpu_torch.client import PoseClient
from bilinear_tpu_torch.data import h36m as ph36m
from bilinear_tpu_torch.io.checkpoint import save_checkpoint
from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.serving import LiftingServer
from bilinear_tpu_torch.serving_http import PoseHTTPServer
from bilinear_tpu_torch.utils.weights import bilinear_from_jax, \
    bilinear_to_jax, end2end_to_jax
from torch_port_fixtures import scrambled_variables


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("Human3.6M"))
    write_h36m_dataset(d, n_train=64, n_valid=16)
    run_dir = str(tmp_path_factory.mktemp("run"))
    trainer = BilinearTrainer(batch_size=16)
    state = trainer.init_state(jax.random.PRNGKey(0))
    jax_save_checkpoint(run_dir + "/parameter", 3, state)
    return d, run_dir, state


def _train(d, port: bool):
    if port:
        return ph36m.load_h36m(d, ph36m.Protocol.GT)[ph36m.Task.Train]
    return load_h36m(d, Protocol.GT)[Task.Train]


def test_from_run_dir_f32_matches_jax_server(setup):
    d, run_dir, _ = setup
    server, epoch = LiftingServer.from_run_dir(
        run_dir, _train(d, True), dtype=torch.float32, device="cpu")
    assert epoch == 3 and server.epoch == 3
    jserver, _ = JaxLiftingServer.from_run_dir(
        run_dir, _train(d, False), dtype=jnp.float32, interpret=True)
    kp = _train(d, True).raw_part[:10].reshape(10, 16, 2)
    mm = server.lift(kp)
    assert mm.shape == (10, 16, 3) and mm.dtype == torch.float32
    np.testing.assert_allclose(mm.numpy(), np.asarray(jserver.lift(kp)),
                               rtol=2e-3, atol=2e-2)
    out = server.lift_normalized(np.zeros((5, 32), np.float32))
    assert out.shape == (5, 48) and torch.isfinite(out).all()


@pytest.mark.parametrize("quantize", ["int8", "int8-static"])
def test_from_run_dir_quantized_matches_jax_server(setup, quantize):
    d, run_dir, _ = setup
    server, _ = LiftingServer.from_run_dir(
        run_dir, _train(d, True), quantize=quantize, device="cpu")
    jserver, _ = JaxLiftingServer.from_run_dir(
        run_dir, _train(d, False), quantize=quantize, interpret=True)
    if quantize == "int8-static":
        js, ps = jserver._engine.static_scales, server._engine.static_scales
        for a, b in zip(js, ps):
            assert abs(a - b) <= 1.01 * 10 ** (np.floor(np.log10(a)) - 2)
    kp = _train(d, True).raw_part[:33].reshape(33, 16, 2)  # odd batch
    mm = server.lift(kp).numpy()
    ref = np.asarray(jserver.lift(kp))
    assert mm.shape == (33, 16, 3)
    scale = np.abs(ref).mean()
    d_ = np.abs(mm - ref)
    assert d_.mean() < 2e-3 * scale and np.percentile(d_, 99) < 2e-2 * scale


def test_reload_picks_up_newer_epoch(setup, tmp_path):
    d, run_dir, state = setup
    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    pdir = str(tmp_path / "parameter")
    save_checkpoint(pdir, 1, *bilinear_to_jax(bilinear_from_jax(params, stats)))
    server, epoch = LiftingServer.from_run_dir(
        str(tmp_path), _train(d, True), dtype=torch.float32, device="cpu")
    assert epoch == 1 and server.reload() is False
    kp = _train(d, True).raw_part[:4].reshape(4, 16, 2)
    before = server.lift(kp)
    p2, s2 = scrambled_variables(1)
    save_checkpoint(pdir, 2, *bilinear_to_jax(bilinear_from_jax(p2, s2)))
    assert server.reload() is True and server.epoch == 2
    assert not torch.allclose(before, server.lift(kp))
    assert server.reload() is False


def test_empty_run_dir_and_bad_arguments(setup, tmp_path):
    d, run_dir, state = setup
    with pytest.raises(FileNotFoundError):
        LiftingServer.from_run_dir(str(tmp_path), _train(d, True),
                                   device="cpu")
    with pytest.raises(ValueError):
        LiftingServer.from_run_dir(run_dir, _train(d, True),
                                   quantize="bogus", device="cpu")
    with pytest.raises(ValueError, match="at least one device"):
        LiftingServer.from_run_dir(run_dir, _train(d, True), mesh=[],
                                   device="cpu")


def test_default_device_is_the_card(setup):
    """Without ``device=`` the server runs on CUDA; with no card it raises
    instead of falling back to the CPU."""
    d, run_dir, _ = setup
    if torch.cuda.is_available():
        server, _ = LiftingServer.from_run_dir(run_dir, _train(d, True))
        assert server.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LiftingServer.from_run_dir(run_dir, _train(d, True))


def _post(url, body: bytes, ctype: str):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def test_http_daemon_and_client(setup, tmp_path):
    d, run_dir, state = setup
    params = jax.tree.map(np.asarray, state.params)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    save_checkpoint(str(tmp_path / "parameter"), 1,
                    *bilinear_to_jax(bilinear_from_jax(params, stats)))
    lifting, _ = LiftingServer.from_run_dir(
        str(tmp_path), _train(d, True), dtype=torch.float32, device="cpu")
    http = PoseHTTPServer(lifting=lifting, port=0, max_delay_ms=5.0)
    http.start()
    try:
        base = f"http://{http.host}:{http.port}"
        client = PoseClient(base)
        kp = _train(d, True).raw_part[:7].reshape(7, 16, 2)
        want = lifting.lift(kp).numpy()

        np.testing.assert_allclose(client.lift(kp), want, rtol=1e-6, atol=1e-4)
        status, body = _post(base + "/v1/lift",
                             json.dumps({"keypoints": kp.tolist()}).encode(),
                             "application/json")
        assert status == 200
        np.testing.assert_allclose(np.asarray(json.loads(body)["poses_mm"]),
                                   want, rtol=1e-6, atol=1e-4)

        health = client.health()
        assert health["status"] == "ok" and health["lift"]["epoch"] == 1
        assert health["lift"]["rows"] == 14 and health["pose"] is None
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            assert 'bilinear_rows_served_total{route="lift"} 14' in r.read().decode()

        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/pose", b"", "application/x-npz")
        assert e.value.code == 404
        buf = io.BytesIO()
        np.save(buf, np.zeros((2, 8, 2), np.float32))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/lift", buf.getvalue(), "application/x-npy")
        assert e.value.code == 400

        assert client.reload() == {"reloaded": False, "epoch": None,
                                   "lift_epoch": 1}
        p2, s2 = scrambled_variables(1)
        save_checkpoint(str(tmp_path / "parameter"), 2,
                        *bilinear_to_jax(bilinear_from_jax(p2, s2)))
        assert client.reload()["lift_epoch"] == 2
        assert client.health()["lift"]["epoch"] == 2
        assert not np.allclose(client.lift(kp), want)
    finally:
        http.stop()


def test_cli_builds_lifting_daemon(setup):
    d, run_dir, _ = setup
    args = pserve.build_parser().parse_args(
        ["--run-dir", run_dir, "--data-dir", d, "--device", "cpu",
         "--port", "0", "--dtype", "float32", "--max-rows", "64"])
    http = pserve.build_server(args)
    http.start()
    try:
        assert http.lifting.epoch == 3 and http.lifting.device.type == "cpu"
        assert http.warm() == {"lift_rows": [64]}
    finally:
        http.stop()
    args = pserve.build_parser().parse_args(
        ["--run-dir", run_dir, "--data-dir", d, "--device", "cpu",
         "--aot", "lifting.aot"])
    with pytest.raises(FileNotFoundError, match="lifting.aot"):
        pserve.build_server(args)  # --aot serves artifacts, not the run


def test_cli_builds_end2end_and_both_daemons(setup, tmp_path):
    """--kind end2end serves /v1/pose alone and --kind both serves it beside
    /v1/lift (its lifting model from --lifting-run-dir), at the small size
    of --n-stacks/--features/--depth, on the CPU; the torch7 detector is
    built fused (its ResModule kernels' plain versions on the CPU), the
    preact one not; --kind end2end --quantize int8 and int8-static build
    an int8 End2EndServer (the detectors' int8 convolutions)."""
    d, run_dir, _ = setup
    e2e_dir = str(tmp_path / "End2End")
    common = ["--data-dir", d, "--device", "cpu",
              "--port", "0", "--n-stacks", "2", "--features", "16",
              "--depth", "2", "--batch-sizes", "1", "2"]
    frames = np.zeros((3, 256, 256, 3), np.uint8)
    for kind, lift_epoch, variant in (("end2end", None, "preact"),
                                      ("both", 3, "torch7")):
        model = End2End(variant=variant, n_stacks=2, features=16, depth=2,
                        generator=torch.Generator().manual_seed(0))
        save_checkpoint(f"{e2e_dir}/{variant}/parameter", 2,
                        *end2end_to_jax(model.state_dict(), variant))
        args = pserve.build_parser().parse_args(
            common + ["--kind", kind, "--lifting-run-dir", run_dir,
                      "--run-dir", f"{e2e_dir}/{variant}",
                      "--variant", variant, "--dtype", "float32"])
        http = pserve.build_server(args)
        http.start()
        try:
            assert http.end2end.epoch == 2
            assert http.end2end._model.fused == (variant == "torch7")
            assert http.end2end.device.type == "cpu"
            client = PoseClient(f"http://{http.host}:{http.port}")
            p2, p3 = client.pose(frames)
            assert p2.shape == (3, 16, 2) and p3.shape == (3, 16, 3)
            assert np.isfinite(p3).all()
            health = client.health()
            assert health["pose"]["epoch"] == 2
            if lift_epoch is None:
                assert health["lift"] is None
            else:
                assert health["lift"]["epoch"] == lift_epoch
                mm = client.lift(np.zeros((2, 16, 2), np.float32))
                assert mm.shape == (2, 16, 3)
        finally:
            http.stop()
    for quantize in ("int8", "int8-static"):
        args = pserve.build_parser().parse_args(
            common + ["--kind", "end2end", "--quantize", quantize,
                      "--run-dir", f"{e2e_dir}/torch7"])
        http = pserve.build_server(args)
        http.start()
        try:
            assert http.end2end.quantize == "int8"
            p2, _ = PoseClient(f"http://{http.host}:{http.port}").pose(
                frames[:1])
            assert np.isfinite(p2).all()
        finally:
            http.stop()
