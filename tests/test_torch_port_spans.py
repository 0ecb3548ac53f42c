"""The port's spans (``utils/profiling.py::span``) and the daemon's new
counters, on the CPU at a small width: no profiler op outside a profile,
the tree of ``End2EndServer.predict``'s spans under a profile scheduled as
``portbench/trace.py::traced`` schedules it, ``lift.call``, ``k3.forward``
/ ``k4.backward``, the End2End trainer's phase ranges, the batcher's queue
wait and request count, and their ``/metrics`` exposition."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from bilinear_tpu_torch import serving
from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.models.hourglass_torch7 import ResModule
from bilinear_tpu_torch.ops import resmodule as rk
from bilinear_tpu_torch.serving import End2EndServer, LiftingServer
from bilinear_tpu_torch.serving_http import DynamicBatcher, PoseHTTPServer
from bilinear_tpu_torch.train import end2end as te
from bilinear_tpu_torch.train import hourglass as th
from bilinear_tpu_torch.utils import weights as wt
from bilinear_tpu_torch.utils.profiling import span
from torch_port_fixtures import one_torch_thread  # noqa: F401

SIZE = dict(n_stacks=1, features=16, depth=2)
SIZES = (2, 4)
FRAMES = 7  # chunks of 4 and 2, then 1 padded to 2


def _server(fused: bool) -> End2EndServer:
    model = End2End(**SIZE, generator=torch.Generator().manual_seed(0))
    params, stats = wt.end2end_to_jax(model.state_dict(), "torch7")
    return End2EndServer(
        {"params": params, "batch_stats": stats}, np.zeros(32),
        np.ones(32), np.zeros(48), np.ones(48), dtype=torch.float32,
        batch_sizes=SIZES, model_kw=dict(SIZE, fused=fused), device="cpu")


@pytest.fixture(scope="module")
def servers():
    return {fused: _server(fused) for fused in (False, True)}


def _frames(n: int) -> np.ndarray:
    return np.random.RandomState(0).randint(0, 256, (n, 256, 256, 3),
                                            dtype=np.uint8)


def _traced(fn):
    """``fn()`` in the recorded step of a profile scheduled as
    ``portbench.trace.traced`` schedules it (one warm-up step first); the
    profile's events."""
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.zeros(1).add_(1)
        prof.step()
        fn()
        prof.step()
    return prof.events()


def _spans(events, names):
    """(name, start, end) of the events named in ``names``, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in events if e.name in names),
                  key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_outside_a_profile_enters_no_profiler_op(servers, monkeypatch):
    """One predict with K3 on its CPU path enters no profiler op when no
    profiler records; the same predict under a profile does (the count
    sees them), and the off span is one shared object."""
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*args):
        calls.append(args[0])
        return enter(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counted)
    server = servers[True]
    frames = _frames(FRAMES)
    server.predict(frames)
    assert calls == []
    assert span("a") is span("b")
    _traced(lambda: server.predict(frames))
    assert "e2e.predict" in calls and "k3.forward" in calls


@pytest.mark.parametrize("fused", [False, True])
def test_predict_spans_form_the_tree(servers, fused):
    """One e2e.predict a call; in it, per chunk, an e2e.h2d then an
    e2e.forward, and after the last chunk one e2e.d2h. Fused, each chunk's
    e2e.forward holds one k3.forward per ResModule; unfused, none runs."""
    server = servers[fused]
    chunks = server._chunks(FRAMES)
    assert chunks == [(4, 4), (2, 2), (1, 2)]
    padded = server.frames_padded
    events = _traced(lambda: server.predict(_frames(FRAMES)))
    assert server.frames_padded == padded + 1
    tree = _spans(events, serving.SPANS)
    assert [s[0] for s in tree] == ["e2e.predict"] + [
        "e2e.h2d", "e2e.forward"] * len(chunks) + ["e2e.d2h"]
    for a, b in zip(tree[1:], tree[2:]):
        assert a[2] <= b[1]  # one after another, none nested in another
    assert all(_inside(s, tree[0]) for s in tree[1:])
    k3 = _spans(events, rk.SPANS)
    per_chunk = sum(isinstance(m, ResModule) for m in server._model.modules())
    forwards = [s for s in tree if s[0] == "e2e.forward"]
    assert len(k3) == (len(chunks) * per_chunk if fused else 0)
    for f in forwards:
        inside = [s for s in k3 if _inside(s, f)]
        assert len(inside) == (per_chunk if fused else 0)


def test_lift_and_lift_normalized_are_one_span_each():
    model = End2End(**SIZE).bilinear
    params, stats = wt.bilinear_to_jax(model.state_dict())
    server = LiftingServer(params, stats, np.zeros(32), np.ones(32),
                           np.zeros(48), np.ones(48), dtype=torch.float32,
                           device="cpu")
    kp = np.random.RandomState(1).randn(5, 16, 2).astype(np.float32)

    def both():
        server.lift(kp)
        server.lift_normalized(kp.reshape(5, 32))

    assert [s[0] for s in _spans(_traced(both), serving.SPANS)] == \
        ["lift.call"] * 2


def test_res_block_calls_show_their_spans():
    """res_block_eval on the CPU: one k3.forward; res_block_train and its
    backward: one k3.forward, then one k4.backward."""
    g = torch.Generator().manual_seed(0)
    ci = co = 16
    ch = co // 2

    def r(*shape):
        return torch.randn(*shape, generator=g)

    def bn(c):
        return (1 + 0.1 * r(c), 0.1 * r(c))

    p = rk.ResParams(r(ci, ch) / 4, r(ch), r(9, ch, ch) / 8, r(ch),
                     r(ch, co) / 3, r(co), *bn(ci), *bn(ch), *bn(ch))
    stats = rk.BatchStats(*(t for c in (ci, ch, ch)
                            for t in (0.1 * r(c), 1 + 0.1 * r(c).abs())))
    x = r(2, 4, 4, ci)
    events = _traced(lambda: rk.res_block_eval(x, p, stats,
                                               dtype=torch.float32))
    assert [s[0] for s in _spans(events, rk.SPANS)] == ["k3.forward"]

    def train():
        xt = x.clone().requires_grad_(True)
        out, _ = rk.res_block_train(xt, p, dtype=torch.float32)
        out.sum().backward()

    assert [s[0] for s in _spans(_traced(train), rk.SPANS)] == \
        ["k3.forward", "k4.backward"]


def test_end2end_train_step_carries_its_profiler_ranges():
    """One CPU-profiled End2EndTrainer step shows each of STEP_RANGES once,
    in order, nested in nothing (as the detector trainer's step)."""
    b = 2
    trainer = te.End2EndTrainer(batch_size=b, model_kw=SIZE, device="cpu")
    state = trainer.init_state(0)
    rng = np.random.RandomState(2)
    batch = dict(
        images=torch.from_numpy(rng.randint(0, 256, (b, 256, 256, 3),
                                            dtype=np.uint8)),
        centers=torch.full((b, 2), 128.0),
        scales=torch.full((b,), 256.0 / 200.0),
        keypoints=torch.from_numpy(
            rng.uniform(60, 200, (b, 16, 2)).astype(np.float32)),
        valid=torch.ones(b, 16, dtype=torch.bool),
        s_norm=torch.from_numpy(rng.randn(b, 48).astype(np.float32)),
        decode_centers=torch.full((b, 2), 500.0),
        decode_scales=torch.full((b,), 4.0))
    stats = (torch.zeros(32), torch.ones(32))
    aug = te.sample_augment(0, 1, 1, b)
    before = state.step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        losses = trainer.train_step(state, batch, stats, aug)
    assert all(np.isfinite(float(v)) for v in losses)
    assert state.step == before + 1
    ranges = _spans(prof.events(), th.STEP_RANGES)
    assert tuple(s[0] for s in ranges) == th.STEP_RANGES
    for a, c in zip(ranges, ranges[1:]):
        assert a[2] <= c[1]


def test_batcher_counts_queue_wait_and_requests():
    """A request that waits behind a 0.2 s dispatch counts that wait; a
    request split over three dispatches counts once."""
    release = threading.Event()

    def slow(x):
        release.wait(timeout=10)
        return (x * 2,)

    b = DynamicBatcher(slow, n_inputs=1, max_delay_ms=0.0, max_rows=2)
    try:
        out = {}
        first = threading.Thread(
            target=lambda: out.update(a=b.submit(np.ones((1, 3)))))
        first.start()
        while b.requests_dispatched < 1:
            time.sleep(0.005)
        second = threading.Thread(
            target=lambda: out.update(b=b.submit(np.arange(15.0)
                                                 .reshape(5, 3))))
        second.start()
        time.sleep(0.2)
        release.set()
        first.join(timeout=10)
        second.join(timeout=10)
        assert not first.is_alive() and not second.is_alive()
        np.testing.assert_array_equal(out["b"][0],
                                      np.arange(15.0).reshape(5, 3) * 2)
        assert b.batches_dispatched == 4 and b.rows_served == 6
        assert b.requests_dispatched == 2
        assert 0.15 <= b.queue_wait_seconds < 5.0
    finally:
        release.set()
        b.stop()


def test_batcher_dispatch_span_on_its_thread():
    """Under a profile of every thread one dispatch is one
    batcher.dispatch, and the backend's own spans nest in it."""
    from torch._C._profiler import _ExperimentalConfig

    def fn(x):
        with span("lift.call"):
            return (x + 1,)

    b = DynamicBatcher(fn, n_inputs=1, max_delay_ms=0.0)
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            b.submit(np.zeros((3, 2)))
    finally:
        b.stop()
    got = _spans(prof.events(), ("batcher.dispatch", "lift.call"))
    assert [s[0] for s in got] == ["batcher.dispatch", "lift.call"]
    assert _inside(got[1], got[0])


def test_metrics_exposition_has_the_new_series():
    """/metrics text after one padded /v1/pose-sized batch: one request, its
    queue wait, and the padded frame, beside the earlier series."""
    end2end = _server(False)
    daemon = PoseHTTPServer(end2end=end2end, max_delay_ms=0.0)
    daemon.start()
    try:
        daemon.pose_batcher.submit(
            _frames(3), np.full((3, 2), 128.0, np.float32),
            np.full((3,), 1.28, np.float32))
        text = daemon.metrics_text()
    finally:
        daemon.stop()
    lines = text.splitlines()
    for series, kind in (("bilinear_queue_wait_seconds_total", "counter"),
                         ("bilinear_requests_total", "counter"),
                         ("bilinear_rows_padded_total", "counter")):
        assert f"# TYPE {series} {kind}" in lines
        assert any(ln.startswith(f"# HELP {series} ") for ln in lines)
    values = {ln.split(" ")[0]: float(ln.split(" ")[1]) for ln in lines
              if not ln.startswith("#")}
    assert values['bilinear_requests_total{route="pose"}'] == 1
    assert values['bilinear_rows_padded_total{route="pose"}'] == 1
    assert values['bilinear_batches_total{route="pose"}'] == 1
    assert values['bilinear_rows_served_total{route="pose"}'] == 3
    assert 0 < values['bilinear_queue_wait_seconds_total{route="pose"}'] \
        < 60
    assert not any("lift" in k for k in values)
