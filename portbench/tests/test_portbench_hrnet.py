"""The HRNet cell on the CPU: ``work_hrnet``'s arithmetic against
``FlopCounterMode`` on the reference and against the published figures,
the parameter count from the layout, a small run of
``pose_bulk.hrnet-w48.bf16`` that is correct, the serving faults of
``test_portbench_faults.py`` that make it not correct, and the import
rule for the new files."""
from __future__ import annotations

import json
import math
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, work_hrnet
from portbench.reference import hrnet as ref
from portbench.reference import hrnet_layout
from portbench.reference.model import Stats
from portbench.tests.conftest import ROOT, SEED
from portbench.tests.test_portbench_faults import half_of_each_chunk, \
    one_answer_moved
from portbench.tests.test_portbench_imports import imported_names, top

CELL = "pose_bulk.hrnet-w48.bf16"
NEW_FILES = ("pose_hrnet.py", "work_hrnet.py", "traffic/pose_bulk_c.py",
             "reference/hrnet.py", "reference/hrnet_layout.py",
             "metrics/hrnet.exchange_ms_per_chunk.py",
             "metrics/hrnet.branches_ms_per_chunk.py",
             "metrics/hrnet_pose_mfu.py")


def config() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "e2e-hrnet-w48.json")) as f:
        return json.load(f)


def narrow(cfg: dict, width: int) -> dict:
    """Every branch ``width / 48`` as wide; blocks and modules as
    published."""
    out = dict(cfg)
    for stage in hrnet_layout.STAGES:
        out[stage] = dict(cfg[stage], num_channels=[
            c * width // 48 for c in cfg[stage]["num_channels"]])
    return out


# The cell at width 8 on 4-frame calls (conftest.py's SMALL holds the other
# cells' small sizes).
SMALL = {"config": {s: narrow(config(), 8)[s] for s in hrnet_layout.STAGES},
         "workload": {"frames_per_call": 4, "batch_sizes": [1, 2, 4],
                      "pool_frames": 16, "check_calls": 2, "start_step": 4}}


def meta_net(cfg: dict) -> ref.HRNet:
    leaves = {}
    for path, kind, shape in hrnet_layout.model_leaves(cfg):
        if kind == "bn":
            leaves[path] = {k: torch.ones(shape, device="meta")
                            for k in ("scale", "bias", "mean", "var")}
        else:
            leaves[path] = {"kernel": torch.ones(shape, device="meta")}
            if kind != "conv":
                leaves[path]["bias"] = torch.ones(shape[-1], device="meta")
    return ref.HRNet(leaves, cfg)


@pytest.mark.parametrize("width,size", [(8, (64, 64)), (16, (96, 64)),
                                        (48, (256, 256))])
def test_macs_match_the_counter(width, size):
    """End2End's convs and lifter through the reference (on the meta
    device: the shapes, no compute), at the yaml's (width, height)."""
    cfg = narrow(config(), width)
    cfg["image_size"] = list(size)
    w, h = size
    cfg["inputRes"], cfg["outputRes"] = h, h // 4
    net = meta_net(cfg)
    frames = torch.ones((1, h, w, 3), dtype=torch.uint8, device="meta")
    stats = Stats(*(torch.ones(n, device="meta") for n in (32, 32, 48, 48)))
    with FlopCounterMode(display=False) as fc:
        ref.end2end(net, stats, frames)
    assert fc.get_total_flops() == 2 * work_hrnet.hrnet_macs(cfg)


GIB = 2 ** 30  # the README's "GFLOPs" are multiply-adds in units of 2^30


def test_published_macs_and_parameters():
    """The README's W48 figures: 14.6 "GFLOPs" at COCO's 17 joints and 256
    x 192, which are multiply-adds over 2^30 (15.70e9 here; W32's 7.1 and
    the 384 x 288 rows' 16.0 and 32.9 read the same way), within 3%; 63.6
    M parameters within 0.5% (16 joints; 17 add 49). At MPII's 256 x 256:
    19.5 x 2^30 = 20.9e9 multiply-adds a frame."""
    cfg = config()
    coco = dict(cfg, nParts=17, image_size=[192, 256])
    assert abs(work_hrnet.hrnet_macs(coco) / GIB / 14.6 - 1) < 0.03
    assert abs(work_hrnet.parameters(cfg) / 63.6e6 - 1) < 0.005
    assert abs(work_hrnet.detector_macs(cfg) / GIB / 19.5 - 1) < 0.03


def test_parameters_are_the_ports():
    """The layout's count is the port model's, built on the meta device."""
    from bilinear_tpu_torch.models.hrnet import PoseHighResolutionNet

    with torch.device("meta"):
        model = PoseHighResolutionNet()
    assert work_hrnet.parameters(config()) == sum(
        math.prod(p.shape) for p in model.parameters())


def judged(seconds: float = 1.0) -> tuple:
    run, traffic = harness.setup_run(CELL, SEED, seconds, False,
                                     device="cpu", sizes=SMALL)
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


@pytest.mark.parametrize("fault", [half_of_each_chunk, one_answer_moved])
def test_fault_comes_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    correct, numbers = judged()
    assert correct is False, numbers


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
    portbench/tests/test_portbench_hrnet.py -m cuda -q``): the HRNet
    reference with fp8 operands in the program's place fails a limit on
    every seed of ``test_portbench_control.SEEDS``."""
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
        correct, checks = harness.judge(numbers, run.workload["limits"])
        assert correct is False, (seed, checks)
        del run, traffic
