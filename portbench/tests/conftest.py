"""Small sizes for the benchmark's CPU tests: the configurations' shapes
with fewer stacks and features, and workloads of a few frames and poses."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {
    "pose_bulk.bf16": {"config": {"nStack": 1, "nFeats": 32, "depth": 2},
                       "workload": {"frames_per_call": 4,
                                    "batch_sizes": [1, 2, 4],
                                    "pool_frames": 16, "check_calls": 2,
                                    "start_step": 4}},
    "pose_http.bf16": {"config": {"nStack": 1, "nFeats": 32, "depth": 2},
                       "workload": {"batch_sizes": [1, 2, 4],
                                    "sizes": [1, 2, 4], "pool_frames": 16,
                                    "rate_per_s": 3.0, "check_requests": 3,
                                    "connections": 4}},
    "lift_bulk.bf16": {"workload": {"rows_per_call": 256, "pool_rows": 1024,
                                    "check_call_range": 8,
                                    "check_calls": 4}},
}
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
