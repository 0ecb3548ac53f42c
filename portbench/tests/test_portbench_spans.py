"""``portbench/spans.py`` and the ``program_span`` readers against
hand-built traces (window clipping, self time under nested and
overlapping children, nothing to read), then on the CPU: a small
``pose_bulk`` and ``lift_bulk`` window under the profiler, read through
``trace.Trace`` as a traced run reads it."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.tests.conftest import SEED, SMALL

MS = 1_000_000  # ns


def trace(host, start=0, end=100 * MS):
    return SimpleNamespace(start=start, end=end, host=host, device=[])


def run_of(t, **counters):
    return SimpleNamespace(trace=t, counters=counters)


# Three calls in a 100 ms window: the first starts before it, the last
# ends after it.
CALLS = [
    (-5 * MS, 30 * MS, "e2e.predict"),
    (-4 * MS, 6 * MS, "e2e.h2d"),            # clipped to 0-6
    (7 * MS, 20 * MS, "e2e.forward"),
    (8 * MS, 9 * MS, "k3.forward"),          # nested in the forward
    (10 * MS, 12 * MS, "k3.forward"),
    (19 * MS, 22 * MS, "e2e.d2h"),           # overlaps the forward
    (22 * MS, 23 * MS, "aten::copy_"),       # not a program span
    (50 * MS, 90 * MS, "e2e.predict"),
    (52 * MS, 60 * MS, "e2e.h2d"),
    (60 * MS, 80 * MS, "e2e.forward"),
    (81 * MS, 89 * MS, "e2e.d2h"),
    (95 * MS, 130 * MS, "e2e.predict"),      # clipped to 95-100
    (101 * MS, 110 * MS, "e2e.h2d"),         # outside the window
    (0, 100 * MS, "portbench.window"),
]


def test_clipped_keeps_the_window_only():
    got = spans.clipped(trace(CALLS), ("e2e.h2d",))
    assert got == [(0, 6 * MS, "e2e.h2d"), (52 * MS, 60 * MS, "e2e.h2d")]


def test_union_of_nested_and_overlapping_intervals():
    assert spans.union_ns([(0, 10), (2, 3), (5, 12), (20, 25)]) == 17
    assert spans.union_ns([]) == 0


def test_sums_means_and_absence():
    t = trace(CALLS)
    assert spans.total_s(t, "e2e.forward") == pytest.approx(0.033)
    assert spans.mean_s(t, "k3.forward") == pytest.approx(0.0015)
    for f in (spans.total_s, spans.mean_s, spans.self_s, spans.outside_s):
        assert f(t, "lift.call") is None
        assert f(trace([]), "e2e.predict") is None


def test_self_time_takes_out_the_union_of_children():
    """First call 0-30 (clipped): children cover 0-6, 7-22 (the forward,
    its nested K3s and the overlapping d2h): 9 ms of self time. Second
    50-90: 52-60, 60-80, 81-89 leave 4 ms. Third, clipped to 95-100 with
    its child outside the window: 5 ms."""
    assert spans.self_s(trace(CALLS), "e2e.predict") == pytest.approx(0.018)
    # a forward's self time leaves out its K3 calls, not its parent's
    # time nor the d2h that only overlaps it
    assert spans.self_s(trace(CALLS), "e2e.forward") == \
        pytest.approx(0.013 - 0.003 + 0.020)


def test_outside_is_the_window_less_the_calls():
    assert spans.outside_s(trace(CALLS), "e2e.predict") == \
        pytest.approx(0.1 - 0.030 - 0.040 - 0.005)


def read(name, run):
    return harness.reader(name)(run)


def test_readers_on_a_built_trace():
    r = run_of(trace(CALLS), calls=3, chunks=3)
    assert read("pose.between_calls_ms_per_call", r) == pytest.approx(25 / 3)
    assert read("pose.host_self_ms_per_call", r) == pytest.approx(18 / 3)
    assert read("pose.h2d_ms_per_call", r) == pytest.approx(14 / 3)
    assert read("pose.dispatch_ms_per_chunk", r) == pytest.approx(33 / 3)
    assert read("k3.host_us_per_call", r) == pytest.approx(1500)
    lift = trace([(10 * MS, 12 * MS, "lift.call"),
                  (15 * MS, 18 * MS, "lift.call")])
    assert read("lift.host_ms_per_call", run_of(lift, calls=2)) == \
        pytest.approx(2.5)


PROGRAM_SPAN = ("pose.between_calls_ms_per_call",
                "pose.host_self_ms_per_call", "pose.h2d_ms_per_call",
                "pose.dispatch_ms_per_chunk", "k3.host_us_per_call",
                "lift.host_ms_per_call")


@pytest.mark.parametrize("name", PROGRAM_SPAN)
def test_readers_find_nothing_without_spans(name):
    """A program without the spans (or an untraced run, or no calls) reads
    None and raises nothing."""
    ops = trace([(1 * MS, 2 * MS, "aten::add")])
    assert read(name, run_of(ops, calls=3, chunks=3)) is None
    assert read(name, run_of(None, calls=3, chunks=3)) is None
    assert read(name, run_of(trace(CALLS))) is None or \
        name == "k3.host_us_per_call"


def cpu_traced(cell: str):
    """A small window of ``cell`` on the CPU, profiled as
    ``trace.traced`` profiles it (one warm-up step, then the recorded
    window inside its own span), read into a ``Trace``."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    from portbench.trace import WINDOW, Trace

    run, traffic = harness.setup_run(cell, SEED, 0.5, True, device="cpu",
                                     sizes=SMALL[cell])
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        prof.step()
        with record_function(WINDOW):
            traffic.window(run, 0.5)
        prof.step()
    run.trace = Trace(prof.profiler.kineto_results.events())
    traffic.release(run)
    return run


def test_pose_readers_on_a_cpu_window():
    """Every pose reader finds its spans; the calls and the time between
    them fill the window."""
    run = cpu_traced("pose_bulk.bf16")
    got = {n: read(n, run) for n in PROGRAM_SPAN[:5]}
    assert all(v is not None and v > 0 for v in got.values()), got
    calls = run.counters["calls"]
    inside = spans.total_s(run.trace, "e2e.predict")
    assert inside + got["pose.between_calls_ms_per_call"] * calls / 1e3 == \
        pytest.approx(run.trace.window_s)
    assert got["pose.host_self_ms_per_call"] < inside * 1e3 / calls
    assert read("lift.host_ms_per_call", run) is None


def test_lift_reader_on_a_cpu_window():
    run = cpu_traced("lift_bulk.bf16")
    v = read("lift.host_ms_per_call", run)
    assert v is not None and v > 0
    assert read("pose.h2d_ms_per_call", run) is None
