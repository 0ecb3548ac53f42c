"""K7's plans (bilinear_tpu_torch/ops/int8.py::plan_conv) on the CPU: the
host-side choice of route, tile and split of K that the CUDA kernel takes
as given. For every conv shape a served int8 forward runs (torch7 and
preact, batches 1-16) and for random valid shapes: the splits cover K once,
the tiles cover the output, the shared memory fits a Hopper block, and
split-K is taken exactly where the output tiles fill at most half a wave of
the card's SMs and K has enough slabs (a fuller grid lost on the card). The plain version of a split (``split_accumulators_ref``)
sums to the plain accumulator bit for bit, which is why the kernel's
split-K is exact. The checks on the card are chip_smoke.py's phase 13.
"""
import numpy as np
import pytest
import torch

from bilinear_tpu_torch.ops import int8
from torch_port_fixtures import one_torch_thread  # noqa: F401

# The distinct (H, W, Ci, Co, k) of the int8 convs of a full-width torch7
# and preact forward (chip_smoke.py INT8_SHAPES, recorded at the wrapper).
SERVED = (
    (128, 128, 64, 64, 1), (128, 128, 64, 64, 3), (128, 128, 64, 128, 1),
    (64, 64, 64, 64, 3), (64, 64, 64, 128, 1), (64, 64, 128, 64, 1),
    (64, 64, 128, 128, 1), (64, 64, 128, 128, 3), (64, 64, 128, 256, 1),
    (64, 64, 256, 128, 1), (32, 32, 128, 128, 3), (32, 32, 128, 256, 1),
    (32, 32, 256, 128, 1), (16, 16, 128, 128, 3), (16, 16, 128, 256, 1),
    (16, 16, 256, 128, 1), (8, 8, 128, 128, 3), (8, 8, 128, 256, 1),
    (8, 8, 256, 128, 1), (4, 4, 128, 128, 3), (4, 4, 128, 256, 1),
    (4, 4, 256, 128, 1))


def _random_shapes(n, seed):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        yield (int(rs.randint(1, 33)), int(rs.randint(1, 140)),
               int(rs.randint(1, 140)), 64 * int(rs.randint(1, 9)),
               16 * int(rs.randint(1, 40)), int(rs.choice([1, 3, 5, 7])))


def _check_plan(plan, b, h, w, ci, co, k):
    kbytes = k * k * ci
    m = b * h * w
    assert plan.route in int8.ROUTES
    assert (plan.bn, plan.depth) in int8.TILES
    # K: the splits' ranges are consecutive, non-empty, whole slabs but the
    # last, and cover [0, K) exactly once.
    ranges = plan.k_ranges(kbytes)
    assert plan.slabs == -(-kbytes // int8.SLAB)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == kbytes
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:]):
        assert hi == nlo and lo % int8.SLAB == 0 and hi % int8.SLAB == 0
    assert all(hi > lo for lo, hi in ranges)
    assert (plan.splits > 1) == (plan.route == "wgmma_splitk")
    # The output: row tiles cover M, column tiles Co, none wholly outside.
    assert plan.m_tiles * int8.CONV_BM >= m > (plan.m_tiles - 1) * int8.CONV_BM
    assert plan.n_tiles * plan.bn >= co > (plan.n_tiles - 1) * plan.bn
    assert plan.smem <= int8.SMEM_LIMIT
    assert plan.smem * int8.TILES[(plan.bn, plan.depth)] <= 233472  # an SM
    assert plan.blocks == plan.m_tiles * plan.n_tiles * plan.splits


def _splits_by_default(plan, k, ci):
    """The plan's rule for split-K: a grid of at most half a wave, and K of
    at least SPLIT_MIN_SLABS slabs."""
    return (2 * plan.m_tiles * plan.n_tiles <= int8.SMS
            and -(-k * k * ci // int8.SLAB) >= int8.SPLIT_MIN_SLABS)


@pytest.mark.parametrize("b", range(1, 17))
def test_plans_of_the_served_shapes(b):
    for shape in SERVED:
        plan = int8.plan_conv(b, *shape)
        _check_plan(plan, b, *shape)
        h, w, ci, co, k = shape
        tiles = plan.m_tiles * plan.n_tiles
        assert (plan.route == "wgmma_splitk") == _splits_by_default(
            plan, k, ci), (b, shape, plan)
        if plan.splits > 1:  # about one wave, never past it by a split
            assert tiles * plan.splits <= int8.SMS
            assert plan.splits <= int8.MAX_SPLITS
        # 128-wide tiles where they fill a wave, else 64-wide ones.
        wide = co > 64 and plan.m_tiles * -(-co // 128) >= int8.SMS
        assert (plan.bn, plan.depth) == ((128, 3) if wide else (64, 4))


def test_the_served_chunk_splits_its_small_levels():
    """At batch 8 (a served chunk) every 3x3 at 16x16 and below splits K;
    every conv at 32x32 and above, and every 1x1 (one or two slabs of K),
    does not; at 64x64 and above a 128-channel conv is one 128-wide tile."""
    for shape in SERVED:
        h, w, ci, co, k = shape
        plan = int8.plan_conv(8, *shape)
        if h >= 32 or k == 1:
            assert plan.route == "wgmma" and plan.splits == 1, shape
        else:
            assert plan.route == "wgmma_splitk" and plan.splits > 1, shape
        if h >= 64 and co == 128:
            assert plan.bn == 128 and plan.n_tiles == 1, shape
    main = int8.plan_conv(8, 64, 64, 128, 128, 3)
    assert main == int8.ConvPlan("wgmma", 128, 3, 1, 9, 9, 256, 1)


@pytest.mark.parametrize("seed", range(4))
def test_plans_of_random_shapes(seed):
    for b, h, w, ci, co, k in _random_shapes(50, seed):
        plan = int8.plan_conv(b, h, w, ci, co, k)
        _check_plan(plan, b, h, w, ci, co, k)
        assert (plan.route == "wgmma_splitk") == _splits_by_default(
            plan, k, ci)
        for route in int8.ROUTES:
            for bn, depth in int8.TILES:
                if route == "wgmma_splitk" and k * k * ci <= int8.SLAB:
                    with pytest.raises(ValueError, match="one slab"):
                        int8.plan_conv(b, h, w, ci, co, k, route, bn, depth)
                    continue
                forced = int8.plan_conv(b, h, w, ci, co, k, route, bn, depth)
                _check_plan(forced, b, h, w, ci, co, k)
                assert forced.route == route
                assert (forced.splits > 1) == (route == "wgmma_splitk")


def test_plan_refuses_unknown_routes_and_tiles():
    with pytest.raises(ValueError, match="no route"):
        int8.plan_conv(8, 16, 16, 128, 128, 3, route="mma_sync")
    with pytest.raises(ValueError, match="no tile"):
        int8.plan_conv(8, 16, 16, 128, 128, 3, bn=32, depth=4)
    with pytest.raises(ValueError, match="no tile"):
        int8.plan_conv(8, 16, 16, 128, 128, 3, bn=256, depth=4)


@pytest.mark.parametrize("b,h,w,ci,co,k", [
    (2, 4, 4, 128, 128, 3),   # a served 4x4 3x3: nine splits of one slab
    (1, 8, 8, 256, 128, 1),   # a served 1x1 of two slabs, split forced
    (3, 7, 9, 64, 48, 3),     # Ci = 64: slabs across two taps, a half slab
    (2, 5, 3, 192, 320, 3),   # Ci = 192, two column tiles
])
def test_split_partials_sum_to_the_accumulator(b, h, w, ci, co, k):
    """The plain version of each split sums, in int32, to the plain
    accumulator bit for bit, for the split plan of every tile and one with
    a split per slab: splitting K is exact."""
    rs = np.random.RandomState(b * 100 + ci)
    xq = torch.from_numpy(rs.randint(-127, 128, (b, h, w, ci)).astype(np.int8))
    kq = torch.from_numpy(rs.randint(-127, 128, (co, k, k, ci)).astype(np.int8))
    full = int8.int8_conv_acc_ref(xq, kq)
    plan0 = int8.plan_conv(b, h, w, ci, co, k, "wgmma_splitk")
    plans = {plan0, plan0._replace(splits=plan0.slabs, per=1)}  # one each
    for bn, depth in int8.TILES:
        plans.add(int8.plan_conv(b, h, w, ci, co, k, "wgmma_splitk", bn,
                                 depth))
    for plan in plans:
        assert plan.splits > 1
        parts = int8.split_accumulators_ref(xq, kq, plan)
        assert len(parts) == plan.splits
        total = torch.zeros_like(full)
        for p in parts:
            assert p.dtype == torch.int32
            total += p
        assert torch.equal(total, full), plan
    # A dropped split (the planted fault of the chip run) changes it.
    dropped = plan0._replace(splits=plan0.splits - 1)
    parts = int8.split_accumulators_ref(xq, kq, dropped)
    assert not torch.equal(sum(parts), full)


def test_the_one_call_entry_refuses_cpu_tensors():
    prepared = int8.prepare_kernel(torch.ones(1, 1, 64, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8.int8_conv_fused_cuda(torch.zeros(1, 2, 2, 64), prepared,
                                  torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        int8.int8_conv_cuda(torch.zeros(1, 2, 2, 64, dtype=torch.int8),
                            torch.ones(1), prepared, torch.float32,
                            int8.plan_conv(1, 2, 2, 64, 16, 1))


def test_int8_conv_on_cpu_runs_the_plain_version(monkeypatch):
    """On a CPU tensor int8_conv never reaches the one-call CUDA entry."""
    monkeypatch.setattr(int8, "int8_conv_fused_cuda",
                        lambda *a, **kw: pytest.fail("CUDA entry called"))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 5, 5, 64).astype(np.float32))
    kern = torch.from_numpy(rs.randn(3, 3, 64, 16).astype(np.float32))
    prepared = int8.prepare_kernel(kern)
    assert torch.equal(int8.int8_conv(x, prepared=prepared),
                       int8.int8_conv_ref(x, prepared=prepared))
