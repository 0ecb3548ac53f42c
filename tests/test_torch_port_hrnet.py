"""HRNet-W48 (``models/hrnet.py``) as End2End's third detector, on the CPU at
width 8 with the published block and module counts: the port against the
benchmark's plain reference (``portbench/reference/hrnet.py``) on its
seeded, calibrated weights in f32 and bf16; ``End2EndServer(variant=
"hrnet")`` against one whole-batch forward, from a tree and from a run
directory with hot reload; the ``.save`` tree's converters; the refusals;
and the model's spans."""
import copy
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bilinear_tpu_torch.io.checkpoint import save_checkpoint
from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.models.hourglass import StackedHourglass
from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
from bilinear_tpu_torch.models.hrnet import SPANS, PoseHighResolutionNet
from bilinear_tpu_torch.parallel.spatial import spatial_forward
from bilinear_tpu_torch.serving import End2EndServer
from bilinear_tpu_torch.train.end2end import End2EndTrainer
from bilinear_tpu_torch.train.hourglass import HourglassTrainer
from bilinear_tpu_torch.models.detectors import make_model
from bilinear_tpu_torch.utils import weights as wt
from portbench import seeds
from torch_port_fixtures import one_torch_thread  # noqa: F401
from torch_port_hrnet_fixtures import (SMALL, WIDTH, _images, _max_rel,
                                       _port, _reference, _stats,
                                       _whole_batch, seeded)  # noqa: F401


def test_f32_matches_the_reference(seeded):
    """Heatmaps (1, B, 16, 16, J) f32 within 1e-5 of the largest: the same
    f32 operations, only the convs' summation order differs (channels-last
    mkldnn against NCHW), ~1e-7 a conv, grown through ~290 convs to 3e-6."""
    w, _, tree = seeded
    images = _images()
    with torch.no_grad():
        out = _port(tree)(images)
    assert out.shape == (1, 4, SMALL // 4, SMALL // 4, 16)
    assert out.dtype == torch.float32
    ref = _reference(w, images)
    assert _max_rel(out[0].permute(0, 3, 1, 2), ref) < 1e-5


def test_bf16_matches_the_reference_in_bf16(seeded):
    """In bf16 both round at the same points (each conv's output, each BN
    back to bf16, the sums); where a summation order or BN's formulation
    flips one rounding the difference travels on. The port's bf16 may
    differ from the reference's bf16 by at most half of what bf16 rounding
    does to the reference (its own distance from f32; the port read 0.25
    of it), and sit no farther from f32 than 1.5 times that."""
    w, _, tree = seeded
    images = _images()
    with torch.no_grad():
        out = _port(tree, torch.bfloat16)(images)[0].permute(0, 3, 1, 2)
    ref32 = _reference(w, images)
    ref16 = _reference(w, images, torch.bfloat16)
    own = _max_rel(ref16, ref32)
    assert own > 1e-3  # bf16 did round
    assert _max_rel(out, ref16) < 0.5 * own
    assert _max_rel(out, ref32) < 1.5 * own


def test_server_pads_and_matches_one_forward(seeded):
    """Five frames as chunks of 4 and 1 padded to 2: the answers of one
    whole-batch forward. In eval mode a frame's answer does not depend on
    its batch; the convs' CPU kernels may still sum in another order at
    another batch size (1e-4 px, 1e-3 mm)."""
    _, stats, tree = seeded
    frames = seeds.frame_pool(11, 5)
    server = End2EndServer(tree, *_stats(stats), variant="hrnet",
                           dtype=torch.float32, batch_sizes=(2, 4),
                           model_kw={"features": WIDTH}, device="cpu")
    p2, p3 = server.predict(frames)
    assert server.frames_padded == 1
    w2, w3 = _whole_batch(tree, stats, frames)
    np.testing.assert_allclose(p2, w2, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p3, w3, rtol=0, atol=1e-3)


def test_server_from_run_dir_and_reload(seeded, tmp_path):
    """A run directory's ``.save`` holds the tree as it is; a later epoch
    is picked up by ``reload``."""
    _, stats, tree = seeded
    pdir = os.path.join(str(tmp_path), "parameter")
    save_checkpoint(pdir, 1, tree["params"], tree["batch_stats"])
    split = types.SimpleNamespace(**dict(zip(
        ("mean_part", "std_part", "mean_s", "std_s"), _stats(stats))))
    server = End2EndServer.from_run_dir(
        str(tmp_path), split, variant="hrnet", model_kw={"features": WIDTH},
        dtype=torch.float32, batch_sizes=(2,), device="cpu")
    frames = seeds.frame_pool(13, 2)
    first = server.predict(frames)
    np.testing.assert_allclose(first[0], _whole_batch(tree, stats,
                                                      frames)[0], atol=1e-4)
    params = copy.deepcopy(tree["params"])
    head = params["hourglass"]["final_layer"]
    head["kernel"] = np.roll(head["kernel"], 1, axis=-1)
    save_checkpoint(pdir, 2, params, tree["batch_stats"])
    assert server.reload() and server.epoch == 2
    assert not np.allclose(server.predict(frames)[0], first[0])


def test_tree_round_trip_and_variants():
    model = PoseHighResolutionNet(width=WIDTH,
                                  generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    params, stats = wt.hrnet_to_jax(sd)
    assert params["stage4"]["2"]["fuse_layers"]["0"]["3"]["0"]["kernel"] \
        .shape == (1, 1, 64, 8)
    assert "1" not in params["stage4"]["2"]["fuse_layers"]  # branch 0 only
    assert stats["layer1"]["0"]["bn1"]["count"].dtype == np.int32
    back = wt.hrnet_from_jax(params, stats)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    cfg = wt.hrnet_config_of_jax(params)
    assert cfg == wt.hrnet_config_of_state_dict(sd) == dict(width=WIDTH,
                                                           n_joints=16)
    trained = {k for k, p in model.named_parameters()}
    assert {k for k, _, _ in wt.hrnet_param_paths(cfg)} == trained
    e2e = End2End(variant="hrnet", features=WIDTH)
    p, s = wt.end2end_to_jax(e2e.state_dict(), "hrnet")
    again = End2End(variant="hrnet", features=WIDTH).load_jax(
        {"params": p, "batch_stats": s})
    for k, v in e2e.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    trees = {
        "torch7": wt.hourglass_torch7_to_jax(
            MainModel(n_stacks=1, features=16, depth=1).state_dict())[0],
        "preact": wt.hourglass_preact_to_jax(
            StackedHourglass(n_stacks=1, features=16, depth=1)
            .state_dict())[0],
        "hrnet": params,
    }
    for variant, tree in trees.items():
        assert wt.detector_variant_of_jax(tree) == variant
    with pytest.raises(ValueError, match="tree's detector is 'hrnet'"):
        wt.end2end_from_jax(p, s, "torch7")


def _tree_of_hrnet() -> dict:
    p, s = wt.end2end_to_jax(
        End2End(variant="hrnet", features=WIDTH).state_dict(), "hrnet")
    return {"params": p, "batch_stats": s}


@pytest.mark.parametrize("refusal", [
    lambda: make_model("hrnet", fused=True),
    lambda: make_model("hrnet", quantize="int8"),
    lambda: make_model("hrnet", n_stacks=2),
    lambda: End2End(variant="hrnet", fused=True),
    lambda: End2EndServer(_tree_of_hrnet(), np.zeros(32), np.ones(32),
                          np.zeros(48), np.ones(48), variant="hrnet",
                          quantize="int8", model_kw={"features": WIDTH},
                          device="cpu"),
    lambda: spatial_forward(PoseHighResolutionNet(width=WIDTH).eval(),
                            torch.zeros(1, 64, 64, 3), ["cpu", "cpu"]),
    lambda: End2EndTrainer(variant="hrnet", device="cpu"),
    lambda: HourglassTrainer(variant="hrnet", device="cpu").init_state(0),
], ids=["fused", "int8", "stacks", "end2end-fused", "server-int8",
        "spatial", "trainer", "hourglass-trainer"])
def test_refusals_name_the_variant(refusal):
    with pytest.raises(ValueError, match="hrnet"):
        refusal()


def test_spans_of_one_forward():
    """One forward under a CPU profile: the stem once, three transitions,
    eight modules' branches and exchanges (1 + 4 + 3), the head once."""
    model = PoseHighResolutionNet(width=WIDTH).eval()
    images = _images(1)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(images)
    counts = {name: 0 for name in SPANS}
    for e in prof.events():
        if e.name in counts:
            counts[e.name] += 1
    assert counts == {"hrnet.stem": 1, "hrnet.transition": 3,
                      "hrnet.branches": 8, "hrnet.exchange": 8,
                      "hrnet.head": 1}
