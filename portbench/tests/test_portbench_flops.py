"""The benchmark's arithmetic against ``FlopCounterMode`` on the plain
reference at batch 1 (on the meta device: the full widths, no compute)."""
from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import work
from portbench.reference import layout
from portbench.reference.model import Net, Stats, end2end, lift
from portbench.tests.conftest import ROOT


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) \
            as f:
        return json.load(f)


def meta_net(cfg: dict) -> Net:
    leaves = {}
    for path, kind, shape in layout.model_leaves(cfg):
        if kind == "bn":
            leaves[path] = {k: torch.ones(shape, device="meta")
                            for k in ("scale", "bias", "mean", "var")}
        else:
            leaves[path] = {"kernel": torch.ones(shape, device="meta"),
                            "bias": torch.ones(shape[-1], device="meta")}
    return Net(leaves)


def stats() -> Stats:
    return Stats(*(torch.ones(n, device="meta") for n in (32, 32, 48, 48)))


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_end2end_flops_match_the_counter():
    cfg = config("e2e-hg8x256")
    net = meta_net(cfg)
    frames = torch.ones((1, 256, 256, 3), dtype=torch.uint8, device="meta")
    assert counted(lambda: end2end(net, cfg, stats(), frames)) \
        == work.end2end_flops(cfg)


@pytest.mark.parametrize("rows", [1, 7])
def test_lifter_flops_match_the_counter(rows):
    cfg = config("lift-1024x2")
    kp = torch.ones((rows, 16, 2), device="meta")
    assert counted(lambda: lift(meta_net(cfg), stats(), kp)) \
        == 2 * rows * work.lifter_macs(cfg)
    assert work.lifter_macs(cfg) == 4_276_224


def test_resmodule_count_and_bounds():
    cfg = config("e2e-hg8x256")
    shapes = work.resmodule_shapes(cfg, 16)
    assert len(shapes) == 107
    bf16 = work.detector_res_bound_ms(cfg, 16, "fwd", "bf16")
    f32 = work.detector_res_bound_ms(cfg, 16, "fwd", "f32")
    assert f32 > 10 * bf16 > 0   # each precision on its own peak


def test_lift_bound_is_chip_smokes_at_bf16():
    """chip_smoke.py::bound("bf16", 65536), which puts bf16 on its peak."""
    cfg = config("lift-1024x2")
    h, i, o = 1024, 32, 48
    macs_hidden, macs_ends = 4 * h * h, i * h + h * o
    rows = 65536 * (i * 2 + o * 4)
    weights = 2 * (macs_ends + macs_hidden) + 4 * (5 * h + o)
    expect = max((rows + weights) / 3.35e12,
                 2 * 65536 * (macs_ends + macs_hidden) / 989e12) * 1e3
    assert work.lift_bound_ms(cfg, "bf16", 65536)[0] == pytest.approx(expect)
