"""A run with its timed path broken underneath must come out not correct.
Each test skips the harness's look for a card, drives set-up, the window,
the release and the check on the CPU at a small width, with the program's
answers broken where they are produced, and judges the numbers by the
cell's own limits. The faults a serving cell can have: half of each batch
left out, and an answer altered."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.conftest import SEED, SMALL


def judged(cell: str, seconds: float = 1.0) -> tuple:
    run, traffic = harness.setup_run(cell, SEED, seconds, False,
                                     device="cpu", sizes=SMALL[cell])
    try:
        harness.measure(run, traffic)
    finally:
        traffic.release(run)
    numbers = traffic.check(run)
    correct, _ = harness.judge(numbers, run.workload["limits"])
    return correct, numbers


def half_of_each_chunk(monkeypatch):
    """End2End: the second half of every chunk's frames never reach the
    model (zero frames in their place)."""
    from bilinear_tpu_torch.serving import End2EndServer

    real = End2EndServer._run

    def broken(self, model, f, c, s):
        f = f.clone()
        f[f.shape[0] // 2:] = 0
        return real(self, model, f, c, s)

    monkeypatch.setattr(End2EndServer, "_run", broken)


def one_answer_moved(monkeypatch):
    """End2End: every predict hands each frame the answer of the next."""
    from bilinear_tpu_torch.serving import End2EndServer

    real = End2EndServer.predict

    def broken(self, frames, centers=None, scales=None):
        p2, p3 = real(self, frames, centers, scales)
        if len(p2) > 1:
            return np.roll(p2, 1, axis=0), np.roll(p3, 1, axis=0)
        return p2 + 8.0, p3
    monkeypatch.setattr(End2EndServer, "predict", broken)


def lift_half(monkeypatch):
    """Lifting: the second half of each call's rows is left out."""
    from bilinear_tpu_torch.serving import LiftingServer

    real = LiftingServer._forward

    def broken(self, x):
        out = real(self, x[: x.shape[0] // 2])
        return torch.cat([out, torch.zeros_like(out)])
    monkeypatch.setattr(LiftingServer, "_forward", broken)


def lift_altered(monkeypatch):
    """Lifting: the first pose of each call given the second's answer."""
    from bilinear_tpu_torch.serving import LiftingServer

    real = LiftingServer._forward

    def broken(self, x):
        out = real(self, x).clone()
        out[0] = out[1]
        return out
    monkeypatch.setattr(LiftingServer, "_forward", broken)


@pytest.mark.parametrize("cell,fault", [
    ("pose_bulk.bf16", half_of_each_chunk),
    ("pose_bulk.bf16", one_answer_moved),
    ("pose_http.bf16", half_of_each_chunk),
    ("pose_http.bf16", one_answer_moved),
    ("lift_bulk.bf16", lift_half),
    ("lift_bulk.bf16", lift_altered),
])
def test_fault_comes_out_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    correct, numbers = judged(cell)
    assert correct is False, numbers


@pytest.mark.parametrize("cell", ["pose_bulk.bf16", "pose_http.bf16",
                                  "lift_bulk.bf16"])
def test_sound_small_run_is_correct(cell):
    """The same small run with nothing broken passes the same limits, so
    the faults above are what fails them."""
    correct, numbers = judged(cell)
    assert correct is True, numbers
