"""JAX-free helpers of the HRNet port tests (``test_torch_port_hrnet.py``,
``test_torch_port_hrnet_epilogue.py``, whose card tests run where JAX is
not installed): the benchmark's seeded, calibrated HRNet at width 8 with
the published block and module counts, the port loaded from its tree, the
reference's heatmaps, and End2End's whole-batch answers."""
import json
import os

import numpy as np
import pytest
import torch

from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.models.hrnet import PoseHighResolutionNet
from bilinear_tpu_torch.ops.decode import decode_to_normalized
from bilinear_tpu_torch.utils import weights as wt
from portbench import pose_hrnet, seeds

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 8
SMALL = 64  # the model tests' frames: 64 x 64, 16 x 16 heatmaps


def small_config() -> dict:
    """e2e-hrnet-w48 at width 8: every branch 1/6 as wide, the published
    block and module counts."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "e2e-hrnet-w48.json")) as f:
        cfg = json.load(f)
    for stage in ("stage2", "stage3", "stage4"):
        cfg[stage] = dict(cfg[stage], num_channels=[
            c * WIDTH // 48 for c in cfg[stage]["num_channels"]])
    return cfg


@pytest.fixture(scope="module")
def seeded():
    """The benchmark's seeded weights at width 8, calibrated by the
    reference on its 256 x 256 calibration frames, and their tree."""
    w, stats = pose_hrnet.hrnet_weights(small_config(), 12345,
                                        torch.device("cpu"))
    return w, stats, w.tree()


def _port(tree, dtype=torch.float32) -> PoseHighResolutionNet:
    model = PoseHighResolutionNet(width=WIDTH, dtype=dtype)
    model.load_state_dict(wt.hrnet_from_jax(tree["params"]["hourglass"],
                                            tree["batch_stats"]["hourglass"]))
    return model.eval()


def _images(n: int = 4, size: int = SMALL) -> torch.Tensor:
    step = 256 // size
    frames = seeds.frame_pool(7, n)[:, ::step, ::step]
    return torch.as_tensor(np.ascontiguousarray(frames)).float() / 255.0


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


def _whole_batch(tree, stats, frames: np.ndarray):
    """One End2End forward and decode over every frame at once, on the
    eval plan a server builds."""
    model = End2End(variant="hrnet", features=WIDTH).load_jax(tree).eval()
    model.hourglass.build_eval_plan()
    n = len(frames)
    f = torch.as_tensor(frames).float() / 255.0
    c = torch.full((n, 2), 128.0)
    s = torch.full((n,), 256.0 / 200.0)
    with torch.no_grad():
        heat, pose2d, p3 = model(f, c, s, stats.mean_part, stats.std_part)
        again, _ = decode_to_normalized(heat[-1], c, s, stats.mean_part,
                                        stats.std_part)
    assert heat.shape[0] == 1 and torch.equal(again, pose2d)
    mm = p3.numpy() * stats.std_s.numpy() + stats.mean_s.numpy()
    return pose2d.numpy(), mm.reshape(n, 16, 3)
