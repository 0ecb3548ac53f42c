"""The ViTPose cell and the small-batch cell on the CPU: ``work_vitpose``'s
arithmetic against ``FlopCounterMode`` on the reference and against the
published figures, the parameter count from the layout, a small run of
``pose_bulk.vitpose-h.bf16`` that is correct, the program's planted faults
that make it not correct, a small run of ``pose_small.bf16``, and the
import rule for the new files."""
from __future__ import annotations

import json
import math
import os

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, work_vitpose
from portbench.reference import vitpose as ref
from portbench.reference import vitpose_layout
from portbench.reference.model import Stats
from portbench.tests.conftest import ROOT, SEED, SMALL
from portbench.tests.test_portbench_faults import one_answer_moved
from portbench.tests.test_portbench_imports import imported_names, top

CELL = "pose_bulk.vitpose-h.bf16"
NEW_FILES = ("pose_vitpose.py", "work_vitpose.py",
             "traffic/pose_bulk_vitpose.py", "traffic/pose_small.py",
             "reference/vitpose.py", "reference/vitpose_layout.py",
             "metrics/vitpose_pose_mfu.py",
             "metrics/vit.attention_roofline.py",
             "metrics/vit.blocks_ms_per_chunk.py")


def config() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "e2e-vitpose-h.json")) as f:
        return json.load(f)


def sized(cfg: dict, embed_dim: int, depth: int, heads: int,
          size: tuple) -> dict:
    """The configuration at another width, depth, head count and (H, W)
    crop; the layer kinds, their order and the head as published."""
    out = dict(cfg)
    out["backbone"] = dict(cfg["backbone"], embed_dim=embed_dim,
                           depth=depth, num_heads=heads, img_size=list(size))
    out["keypoint_head"] = dict(cfg["keypoint_head"], in_channels=embed_dim)
    rows, cols = vitpose_layout.grid(out)
    out["image_size"], out["heatmap_size"] = [size[1], size[0]], [
        4 * cols, 4 * rows]
    return out


# The cell at 64 wide, 2 blocks of 4 heads on 64 x 48 crops, 4-frame calls
# (conftest.py's SMALL holds the other cells' small sizes).
SMALL_VIT = {"config": {k: v for k, v in sized(config(), 64, 2, 4, (
    64, 48)).items() if k in ("backbone", "keypoint_head", "image_size",
                              "heatmap_size")},
             "workload": {"frames_per_call": 4, "batch_sizes": [1, 2, 4],
                          "pool_frames": 16, "check_calls": 2,
                          "start_step": 4}}
# pose_small at the hourglass's small size, on calls of 1, 2 and 4 frames.
SMALL_CALLS = {"config": SMALL["pose_bulk.bf16"]["config"],
               "workload": {"batch_sizes": [1, 2, 4], "sizes": [1, 2, 4],
                            "pool_frames": 16, "check_frames": 8,
                            "start_step": 4, "max_calls": 6}}


def meta_net(cfg: dict) -> ref.ViTPose:
    leaves = {}
    for path, kind, shape in vitpose_layout.model_leaves(cfg):
        if kind == "bn":
            leaves[path] = {k: torch.ones(shape, device="meta")
                            for k in ("scale", "bias", "mean", "var")}
        elif kind == "ln":
            leaves[path] = {k: torch.ones(shape, device="meta")
                            for k in ("scale", "bias")}
        elif kind == "pos":
            leaves[path] = {"value": torch.ones(shape, device="meta")}
        else:
            leaves[path] = {"kernel": torch.ones(shape, device="meta")}
            if kind != "deconv":
                leaves[path]["bias"] = torch.ones(shape[-1], device="meta")
    return ref.ViTPose(leaves, cfg)


@pytest.mark.parametrize("embed_dim,depth,heads,size", [
    (64, 2, 4, (64, 48)), (96, 3, 3, (128, 96)), (1280, 32, 16, (256, 192))])
def test_macs_match_the_counter(embed_dim, depth, heads, size):
    """End2End's products through the reference (on the meta device: the
    shapes, no compute), including attention's two and the head's
    transposed convs, at two small sizes and the published one."""
    cfg = sized(config(), embed_dim, depth, heads, size)
    net = meta_net(cfg)
    frames = torch.ones((1,) + size + (3,), dtype=torch.uint8,
                        device="meta")
    stats = Stats(*(torch.ones(n, device="meta") for n in (32, 32, 48, 48)))
    with FlopCounterMode(display=False) as fc:
        ref.end2end(net, stats, frames)
    assert fc.get_total_flops() == 2 * work_vitpose.vitpose_macs(cfg)


def test_published_macs_and_parameters():
    """ViTPose-H at 256 x 192 with MPII's 16 joints: 192 tokens, 125.83 G
    multiply-adds a frame (the blocks' Linears 120.80 G, attention 3.02 G,
    the patch embedding 0.19 G, the head 1.82 G) and 637.2 M parameters
    with the head; attention's bound on a 128-frame chunk is its bytes,
    2.40 ms."""
    cfg = config()
    assert work_vitpose.tokens(cfg) == 192
    assert round(work_vitpose.detector_macs(cfg) / 1e9, 2) == 125.83
    assert round(work_vitpose.parameters(cfg) / 1e6, 1) == 637.2
    assert round(work_vitpose.attention_bound_ms(cfg, 128), 2) == 2.40


def test_parameters_are_the_ports():
    """The layout's count is the port model's, built on the meta device."""
    from bilinear_tpu_torch.models.vitpose import ViTPose

    with torch.device("meta"):
        model = ViTPose()
    assert work_vitpose.parameters(config()) == sum(
        math.prod(p.shape) for p in model.parameters())


def judged(cell: str = CELL, sizes=None, seconds: float = 1.0) -> tuple:
    run, traffic = harness.setup_run(cell, SEED, seconds, False,
                                     device="cpu", sizes=sizes or SMALL_VIT)
    try:
        harness.measure(run, traffic)
    finally:
        traffic.release(run)
    assert run.state["pool"].flags.c_contiguous
    numbers = traffic.check(run)
    correct, _ = harness.judge(numbers, run.workload["limits"])
    return correct, numbers


def test_sound_small_run_is_correct():
    correct, numbers = judged()
    assert correct is True, numbers


def no_attention_scale(monkeypatch):
    """Attention's logits left unscaled (no 1/sqrt(head_dim))."""
    from bilinear_tpu_torch.models import vitpose as mv

    real = F.scaled_dot_product_attention
    monkeypatch.setattr(mv, "_sdpa",
                        lambda q, k, v: real(q, k, v, scale=1.0))


def first_position_dropped(monkeypatch):
    """``pos_embed[:, :1]`` left out of the tokens."""
    from bilinear_tpu_torch.models.vitpose import ViTPose

    def table(self):
        pos = self.backbone.pos_embed
        return (self.backbone.patch_embed.proj.bias + pos[:, 1:]).to(
            self.dtype)

    monkeypatch.setattr(ViTPose, "_positions", table)


def layer_norm_affine_dropped(monkeypatch):
    """Each LayerNorm without its scale and bias. (An eps of 1e-5 for
    vit.py's 1e-6 is no fault a comparison can see: the LayerNorms' inputs
    vary by 0.03-0.1 across the channels, so it moves their outputs by
    ~5e-5, a tenth of one bf16 rounding; the small run read 1.02 with it,
    1.016 without. ``test_torch_port_vitpose.py`` holds the eps.)"""
    from bilinear_tpu_torch.models.vitpose import ViTPose

    def norm(self, m, x, plan):
        return F.layer_norm(x, m.normalized_shape, None, None, m.eps)

    monkeypatch.setattr(ViTPose, "_norm", norm)


def head_bn_skipped(monkeypatch):
    """The head's BNs left out: each deconvolution goes straight to its
    ReLU."""
    from bilinear_tpu_torch.models import vitpose as mv

    def identity(bn, dtype=torch.float32):
        ones = torch.ones(bn.num_features, dtype=dtype,
                          device=bn.weight.device)
        return torch.stack([ones, torch.zeros_like(ones)])

    monkeypatch.setattr(mv, "bn_affine", identity)


@pytest.mark.parametrize("fault", [no_attention_scale,
                                   first_position_dropped,
                                   layer_norm_affine_dropped,
                                   head_bn_skipped, one_answer_moved])
def test_fault_comes_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    correct, numbers = judged()
    assert correct is False, numbers


def test_small_calls_run_is_correct():
    """``pose_small.bf16`` at the hourglass's small size: calls of 1, 2 and
    4 frames in turn, each one unpadded chunk, a whole number of cycles,
    and a checked sample of at least 8 frames. The window ends on its
    ``max_calls`` (two cycles, 14 frames), not on the clock, so a slow
    host cannot leave fewer frames than the sample asks for."""
    run, traffic = harness.setup_run("pose_small.bf16", SEED, 1.0, False,
                                     device="cpu", sizes=SMALL_CALLS)
    try:
        cycles = traffic.window(run, 3600.0)
    finally:
        traffic.release(run)
    calls = run.counters["calls"]
    assert cycles == 2
    assert calls == 3 * cycles and run.counters["chunks"] == calls
    assert run.counters["frames"] == 7 * cycles
    numbers = traffic.check(run)
    assert numbers["frames_compared"] >= 8
    correct, _ = harness.judge(numbers, run.workload["limits"])
    assert correct is True, numbers


def test_new_files_import_no_jax_and_the_reference_no_program():
    for name in NEW_FILES:
        path = os.path.join(ROOT, "portbench", name)
        for mod in imported_names(path):
            assert top(mod) not in harness.FORBIDDEN, (name, mod)
            if name.startswith("reference/"):
                assert top(mod) != "bilinear_tpu_torch", (name, mod)


@pytest.mark.cuda
def test_control_comes_out_not_correct():
    """On the card, at the cell's own size (``python3 -m pytest
    portbench/tests/test_portbench_vitpose.py -m cuda -q``): the ViTPose
    reference with fp8 operands in the program's place fails every limit
    on every seed of ``test_portbench_control.SEEDS``."""
    import gc

    from portbench.tests.test_portbench_control import SEEDS

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in SEEDS:
        run, traffic = harness.setup_run(CELL, seed, 3.0, False,
                                         control=True)
        harness.measure(run, traffic)
        traffic.release(run)
        gc.collect()
        torch.cuda.empty_cache()
        numbers = traffic.check(run)
        _, checks = harness.judge(numbers, run.workload["limits"])
        print(seed, json.dumps(checks))
        assert all(c["value"] > c["limit"] for c in checks.values()), \
            (seed, checks)
        del run, traffic
