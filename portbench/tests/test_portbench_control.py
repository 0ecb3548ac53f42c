"""On the card, at each cell's own size: the control, the program's int8
path (K6/K7 for the detector, K2 for the lifter) in place of the sound
bf16 one, must come out not correct on every seed.

    python3 -m pytest portbench/tests/test_portbench_control.py -m cuda -q

The check skips without a card; it decides so inside the test."""
from __future__ import annotations

import gc

import pytest

from portbench import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pose_bulk.bf16", "lift_bulk.bf16"])
def test_control_comes_out_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for seed in SEEDS:
        run, traffic = harness.setup_run(cell, seed, 3.0, False, control=True)
        harness.measure(run, traffic)
        traffic.release(run)
        gc.collect()
        torch.cuda.empty_cache()
        numbers = traffic.check(run)
        correct, checks = harness.judge(numbers, run.workload["limits"])
        assert correct is False, (seed, checks)
        del run, traffic
