"""ViTPose (``models/vitpose.py``) as End2End's fourth detector, on the CPU
at 64 wide, 2 blocks of 4 heads of 16, on 64 x 48 crops (4 x 3 tokens, 16
x 12 heatmaps): the port against the benchmark's plain reference
(``portbench/reference/vitpose.py``) on its seeded, calibrated weights in
f32 and bf16; the eval plan's lifetime and the refusal of a train-mode
forward;
``End2EndServer(variant="vitpose")`` against one whole-batch forward, from
a tree and from a run directory with hot reload, and ``/v1/pose`` on the
detector's own frame shape; the ``.save`` tree's converters; the
refusals; the spans and the attention counter of one forward; and the
decode's per-axis map."""
import copy
import io
import json
import os
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bilinear_tpu_torch.io.checkpoint import save_checkpoint
from bilinear_tpu_torch.models import vitpose as mv
from bilinear_tpu_torch.models.detectors import make_model
from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.models.vitpose import SPANS, ViTPose
from bilinear_tpu_torch.ops.decode import decode_to_normalized, \
    heatmap_to_image_space
from bilinear_tpu_torch.parallel.spatial import spatial_forward
from bilinear_tpu_torch.serving import End2EndServer
from bilinear_tpu_torch.serving_http import PoseHTTPServer
from bilinear_tpu_torch.train.end2end import End2EndTrainer
from bilinear_tpu_torch.train.hourglass import HourglassTrainer
from bilinear_tpu_torch.utils import weights as wt
from portbench import pose_vitpose
from torch_port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(embed_dim=64, depth=2, heads=4, image_size=(64, 48))


def small_config() -> dict:
    """e2e-vitpose-h at the tests' size: the published layer kinds, their
    order and the head, narrower, shallower and on a 64 x 48 crop."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "e2e-vitpose-h.json")) as f:
        cfg = json.load(f)
    cfg["backbone"] = dict(cfg["backbone"], embed_dim=64, depth=2,
                           num_heads=4, img_size=[64, 48])
    cfg["keypoint_head"] = dict(cfg["keypoint_head"], in_channels=64)
    cfg["image_size"], cfg["heatmap_size"] = [48, 64], [12, 16]
    return cfg


@pytest.fixture(scope="module")
def seeded():
    """The benchmark's seeded weights at the tests' size, calibrated by the
    reference, their tree, and the configuration."""
    cfg = small_config()
    w, stats = pose_vitpose.vitpose_weights(cfg, 12345, torch.device("cpu"))
    return w, stats, w.tree(), cfg


def _state(tree) -> dict:
    return wt.vitpose_from_jax(tree["params"]["hourglass"],
                               tree["batch_stats"]["hourglass"])


def _port(tree, dtype=torch.float32) -> ViTPose:
    model = ViTPose(dtype=dtype, **SIZE)
    model.load_state_dict(_state(tree))
    return model.eval()


def _images(cfg, n: int = 4) -> torch.Tensor:
    return torch.as_tensor(pose_vitpose.frame_pool(cfg, 7, n)).float() / 255


def _reference(w, images, dtype=None) -> torch.Tensor:
    w.net.dtype = dtype
    try:
        with torch.no_grad():
            return w.net.detector(images)
    finally:
        w.net.dtype = None


def _max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _stats(stats):
    return [s.numpy() for s in (stats.mean_part, stats.std_part,
                                stats.mean_s, stats.std_s)]


def test_f32_matches_the_reference(seeded):
    """Heatmaps (1, B, 16, 12, J) f32 within 1e-5 of the largest: the same
    f32 operations, where only the products' summation order differs
    (``F.linear`` and SDPA against ``@``; the port read 6e-7)."""
    w, _, tree, cfg = seeded
    images = _images(cfg)
    with torch.no_grad():
        out = _port(tree)(images)
    assert out.shape == (1, 4, 16, 12, 16) and out.dtype == torch.float32
    assert _max_rel(out[0].permute(0, 3, 1, 2), _reference(w, images)) \
        < 1e-5


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def test_bf16_matches_the_reference_in_bf16(seeded):
    """In bf16 both round at the same points (each Linear's output once,
    each LayerNorm's, q, k, v, the softmax weights, GELU's, each residual
    sum, the head's convs and BNs); SDPA's kernel rounds its softmax
    weights at its own points, and where that flips one bf16 rounding of
    an attention output the difference travels on, to single pixels of the
    heatmaps. So the distances are relative L2 norms over the heatmaps:
    the port's bf16 may differ from the reference's bf16 by at most half
    of what bf16 rounding does to the reference (its own distance from
    f32; over seeds 1, 2, 3 and 12345 the port read 0 to 0.22 of it), and
    sit no farther from f32 than 1.5 times that."""
    w, _, tree, cfg = seeded
    images = _images(cfg)
    with torch.no_grad():
        out = _port(tree, torch.bfloat16)(images)[0].permute(0, 3, 1, 2)
    ref32 = _reference(w, images)
    ref16 = _reference(w, images, torch.bfloat16)
    own = _rel_l2(ref16, ref32)
    assert own > 1e-3  # bf16 did round
    assert _rel_l2(out, ref16) < 0.5 * own
    assert _rel_l2(out, ref32) < 1.5 * own


def _moved_head(tree) -> dict:
    """The tree's state with ``final_layer``'s kernel rolled by a channel."""
    state = _state(tree)
    w = state["keypoint_head.final_layer.weight"]
    state["keypoint_head.final_layer.weight"] = torch.roll(w, 1, 1)
    return state


# What may happen to an eval model after a forward, and the state it
# then holds.
AFTER_A_FORWARD = {
    "load_state_dict": lambda m, tree: (m.load_state_dict(_moved_head(tree)),
                                        _moved_head(tree))[1],
    "to": lambda m, tree: (m.to(torch.float64).to(torch.float32),
                           _state(tree))[1],
    "train": lambda m, tree: (m.train().eval(), _state(tree))[1],
}


@pytest.mark.parametrize("change", list(AFTER_A_FORWARD))
def test_eval_plan_follows_the_parameters(seeded, change):
    """The first eval forward builds the plan; a new state, a move or cast,
    or train mode drops it, and the next forward builds it again from the
    parameters as they are then: its answer is a fresh model's on the same
    state, bit for bit."""
    _, _, tree, cfg = seeded
    images = _images(cfg, 2)
    model = _port(tree)
    assert model.plan is None
    with torch.no_grad():
        first = model(images)
        assert model.plan is not None
        state = AFTER_A_FORWARD[change](model, tree)
        assert model.plan is None
        again = model(images)
        fresh = ViTPose(**SIZE)
        fresh.load_state_dict(state)
        want = fresh.eval()(images)
    assert torch.equal(again, want)
    assert torch.equal(again, first) is (change != "load_state_dict")


def test_train_mode_forward_is_refused():
    """The port serves ViTPose and does not train it: no train-mode
    forward, rather than an eval answer under a train-mode model."""
    with pytest.raises(ValueError, match="vitpose.*eval mode only"):
        ViTPose(**SIZE).train()(torch.rand(1, 64, 48, 3))


def _whole_batch(tree, stats, cfg, frames: np.ndarray):
    """One End2End forward and decode over every frame at once, on the
    eval plan a server builds, with the default box centred on the crop."""
    model = End2End(variant="vitpose", **SIZE).load_jax(tree).eval()
    model.hourglass.build_eval_plan()
    n = len(frames)
    f = torch.as_tensor(frames).float() / 255.0
    c, s = pose_vitpose.default_box(cfg, n, "cpu")
    with torch.no_grad():
        heat, pose2d, p3 = model(f, c, s, stats.mean_part, stats.std_part)
        again, _ = decode_to_normalized(heat[-1], c, s, stats.mean_part,
                                        stats.std_part,
                                        size=model.heatmap_size)
    assert model.heatmap_size == (16, 12)
    assert heat.shape[0] == 1 and torch.equal(again, pose2d)
    mm = p3.numpy() * stats.std_s.numpy() + stats.mean_s.numpy()
    return pose2d.numpy(), mm.reshape(n, 16, 3)


def _server(tree, stats, **kw) -> End2EndServer:
    return End2EndServer(tree, *_stats(stats), variant="vitpose",
                         dtype=torch.float32, model_kw=dict(SIZE),
                         device="cpu", **kw)


def test_server_pads_and_matches_one_forward(seeded):
    """Five 64 x 48 crops as chunks of 4 and 1 padded to 2: the answers of
    one whole-batch forward. In eval mode a frame's answer does not depend
    on its batch; the CPU's products may still sum in another order at
    another batch size (1e-4 px, 1e-3 mm). The default box is centred on
    the crop, (24, 32), at scale 64/200."""
    _, stats, tree, cfg = seeded
    frames = pose_vitpose.frame_pool(cfg, 11, 5)
    server = _server(tree, stats, batch_sizes=(2, 4))
    assert server.input_size == (64, 48)
    p2, p3 = server.predict(frames)
    assert server.frames_padded == 1
    w2, w3 = _whole_batch(tree, stats, cfg, frames)
    np.testing.assert_allclose(p2, w2, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p3, w3, rtol=0, atol=1e-3)
    box = server.predict(frames, np.tile([24.0, 32.0], (5, 1)),
                         np.full(5, 64 / 200.0))
    np.testing.assert_array_equal(box[0], p2)


def test_server_from_run_dir_and_reload(seeded, tmp_path):
    """A run directory's ``.save`` holds the tree as it is; a later epoch
    is picked up by ``reload``."""
    _, stats, tree, cfg = seeded
    pdir = os.path.join(str(tmp_path), "parameter")
    save_checkpoint(pdir, 1, tree["params"], tree["batch_stats"])
    split = types.SimpleNamespace(**dict(zip(
        ("mean_part", "std_part", "mean_s", "std_s"), _stats(stats))))
    server = End2EndServer.from_run_dir(
        str(tmp_path), split, variant="vitpose", model_kw=dict(SIZE),
        dtype=torch.float32, batch_sizes=(2,), device="cpu")
    frames = pose_vitpose.frame_pool(cfg, 13, 2)
    first = server.predict(frames)
    np.testing.assert_allclose(first[0], _whole_batch(tree, stats, cfg,
                                                      frames)[0], atol=1e-4)
    params = copy.deepcopy(tree["params"])
    head = params["hourglass"]["keypoint_head"]["final_layer"]
    head["kernel"] = np.roll(head["kernel"], 1, axis=-1)
    save_checkpoint(pdir, 2, params, tree["batch_stats"])
    assert server.reload() and server.epoch == 2
    assert not np.allclose(server.predict(frames)[0], first[0])


def test_layer_norms_take_the_published_eps(seeded):
    """vit.py's ``partial(nn.LayerNorm, eps=1e-6)``, in the port and in the
    reference's configuration: an eps of torch's 1e-5 moves the outputs by
    less than bf16 rounding, so no comparison of answers could see it."""
    model = ViTPose(**SIZE)
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2 * SIZE["depth"] + 1
    assert {m.eps for m in norms} == {1e-6}
    assert seeded[0].net.ln_eps == 1e-6


def test_tree_round_trip_and_config():
    model = ViTPose(generator=torch.Generator().manual_seed(0), **SIZE)
    sd = model.state_dict()
    params, stats = wt.vitpose_to_jax(sd)
    bb = params["backbone"]
    assert bb["blocks"]["1"]["attn"]["qkv"]["kernel"].shape == (64, 192)
    assert bb["pos_embed"].shape == (1, 13, 64)
    assert bb["patch_embed"]["proj"]["kernel"].shape == (16, 16, 3, 64)
    deconv = params["keypoint_head"]["deconv_layers"]
    assert deconv["0"]["kernel"].shape == (4, 4, 64, 256)
    assert set(stats) == {"keypoint_head"}  # BN statistics only
    assert stats["keypoint_head"]["deconv_layers"]["4"]["count"].dtype \
        == np.int32
    back = wt.vitpose_from_jax(params, stats)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    cfg = wt.vitpose_config_of_jax(params)
    assert cfg == wt.vitpose_config_of_state_dict(sd) == dict(
        embed_dim=64, depth=2, tokens=12, n_joints=16)
    paths = list(wt.vitpose_param_paths(cfg))
    assert [k for k, _, _ in paths] == [k for k, _ in
                                        model.named_parameters()]
    for key, path, kind in paths:
        np.testing.assert_array_equal(wt.get_leaf(params, path),
                                      wt.leaf_to_jax(sd[key], kind))
    assert wt.detector_variant_of_jax(params) == "vitpose"
    e2e = End2End(variant="vitpose", **SIZE)
    p, s = wt.end2end_to_jax(e2e.state_dict(), "vitpose")
    again = End2End(variant="vitpose", **SIZE).load_jax(
        {"params": p, "batch_stats": s})
    for k, v in e2e.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    with pytest.raises(ValueError, match="tree's detector is 'vitpose'"):
        wt.end2end_from_jax(p, s, "hrnet")


def _tree_of_vitpose(**size) -> dict:
    p, s = wt.end2end_to_jax(End2End(
        variant="vitpose", generator=torch.Generator().manual_seed(1),
        **size).state_dict(), "vitpose")
    return {"params": p, "batch_stats": s}


@pytest.mark.parametrize("refusal", [
    lambda: make_model("vitpose", fused=True),
    lambda: make_model("vitpose", quantize="int8"),
    lambda: make_model("vitpose", n_stacks=2),
    lambda: make_model("vitpose", features=8),
    lambda: End2End(variant="vitpose", fused=True),
    lambda: End2EndServer(_tree_of_vitpose(**SIZE), np.zeros(32),
                          np.ones(32), np.zeros(48), np.ones(48),
                          variant="vitpose", quantize="int8",
                          model_kw=dict(SIZE), device="cpu"),
    lambda: spatial_forward(ViTPose(**SIZE).eval(),
                            torch.zeros(1, 64, 48, 3), ["cpu", "cpu"]),
    lambda: End2EndTrainer(variant="vitpose", device="cpu"),
    lambda: HourglassTrainer(variant="vitpose", device="cpu").init_state(0),
], ids=["fused", "int8", "stacks", "features", "end2end-fused",
        "server-int8", "spatial", "trainer", "hourglass-trainer"])
def test_refusals_name_the_variant(refusal):
    with pytest.raises(ValueError, match="vitpose"):
        refusal()


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (2, 48, 64, 3),
                                   (2, 64, 48, 1)])
def test_server_refuses_frames_of_another_shape(shape):
    server = End2EndServer(_tree_of_vitpose(**SIZE), np.zeros(32),
                           np.ones(32), np.zeros(48), np.ones(48),
                           variant="vitpose", model_kw=dict(SIZE),
                           device="cpu")
    with pytest.raises(ValueError, match=r"\(N, 64, 48, 3\)"):
        server.predict(np.zeros(shape, np.uint8))


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return np.load(io.BytesIO(r.read()))


def test_pose_route_takes_the_detectors_frame_shape():
    """/v1/pose on a small ViTPose at the published 256 x 192 crop: a
    256 x 192 frame is answered as ``predict`` answers it (the default box
    centred on the crop), a 256 x 256 frame is refused with a 400 that
    names the expected shape."""
    size = dict(embed_dim=32, depth=1, heads=2)
    server = End2EndServer(_tree_of_vitpose(**size), np.zeros(32),
                           np.ones(32), np.zeros(48), np.ones(48),
                           variant="vitpose", dtype=torch.float32,
                           batch_sizes=(1, 2), model_kw=size, device="cpu")
    assert server.input_size == (256, 192)
    frames = np.random.RandomState(3).randint(0, 256, (2, 256, 192, 3),
                                              dtype=np.uint8)
    http = PoseHTTPServer(end2end=server, max_delay_ms=0.0)
    http.start()
    try:
        url = f"http://{http.host}:{http.port}/v1/pose"
        got = _post(url, _npz(frames=frames))
        want = server.predict(frames)
        np.testing.assert_array_equal(got["pose2d"], want[0])
        np.testing.assert_array_equal(got["pose3d_mm"], want[1])
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, _npz(frames=np.zeros((1, 256, 256, 3), np.uint8)))
        assert e.value.code == 400
        assert b"(N, 256, 192, 3)" in e.value.read()
    finally:
        http.stop()


def test_spans_and_attention_calls_of_one_forward():
    """One forward under a CPU profile: the patch embedding, the blocks and
    the head once, attention and the MLP once a block; each block's
    attention counted once, by the backend torch chose (never cuDNN's or
    the memory-efficient kernel on the CPU)."""
    model = ViTPose(**SIZE).eval()
    before = dict(mv.ATTENTION_CALLS)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(torch.rand(1, 64, 48, 3))
    counts = {name: 0 for name in SPANS}
    for e in prof.events():
        if e.name in counts:
            counts[e.name] += 1
    assert counts == {"vit.patch_embed": 1, "vit.blocks": 1,
                      "vit.attention": 2, "vit.mlp": 2, "vit.head": 1}
    added = {k: v - before[k] for k, v in mv.ATTENTION_CALLS.items()}
    assert sum(added.values()) == 2
    assert added["cudnn"] == added["efficient"] == 0


def test_square_decode_keeps_its_bits():
    """A 64 x 64 heatmap (the hourglasses' and HRNet's) maps to the frame
    by the single expression it always took, bit for bit, alone and
    through End2End's decode."""
    g = torch.Generator().manual_seed(0)
    pose = torch.rand(5, 16, 2, generator=g) * 63
    centers = torch.rand(5, 2, generator=g) * 500
    scales = torch.rand(5, generator=g) * 3 + 0.5
    before = centers[..., None, :] + (pose - 64 // 2) / 64 * (
        scales[..., None, None] * 200.0)
    assert torch.equal(heatmap_to_image_space(pose, centers, scales), before)
    assert torch.equal(heatmap_to_image_space(pose, centers, scales,
                                              (64, 64)), before)
    heat = torch.randn(5, 64, 64, 16, generator=g)
    mean, std = torch.zeros(32), torch.ones(32)
    img, _ = decode_to_normalized(heat, centers, scales, mean, std)
    from bilinear_tpu_torch.ops.decode import softargmax

    hm = softargmax(heat.permute(0, 3, 1, 2))
    assert torch.equal(img, centers[..., None, :] + (hm - 32) / 64 * (
        scales[..., None, None] * 200.0))


def test_non_square_decode_maps_each_axis():
    """A 64 x 48 heatmap (ViTPose's) under a box 256 px tall at centre
    (96, 128), scale 1.28: the box is 192 px wide, so a heatmap pixel is 4
    frame px on both axes; the heatmap's centre (24, 32) is the box's."""
    pose = torch.tensor([[[24.0, 32.0], [0.0, 0.0], [47.0, 63.0],
                          [12.5, 40.0]]])
    got = heatmap_to_image_space(pose, torch.tensor([[96.0, 128.0]]),
                                 torch.tensor([1.28]), (64, 48))
    want = torch.tensor([[[96.0, 128.0], [0.0, 0.0], [188.0, 252.0],
                          [50.0, 160.0]]])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
