"""The traced window: a ``torch.profiler`` trace of one measured window, read
into device intervals, host spans and a breakdown.

The window is padded as ``chip_smoke.py::_trace`` pads its windows: the
profiler's warm-up step runs first (on a busy host the tracer comes up late
and loses the first launches after its start), the recorded window opens
``pad`` seconds after it and closes ``pad`` seconds after the card has
finished, because the profiler keeps a device record only where it falls
inside the window on the host's clock. As ``_trace_whole`` does, a trace in
which the profiler dropped records (a bulk cell's kernels must come a whole
number of times per call) is taken again with twice the pad, at most
``ATTEMPTS`` times.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

WINDOW = "portbench.window"
ATTEMPTS = 4
TOP = 10


def _kind(name: str) -> str:
    """"copy", "set" or "kernel": the profiler names copies and memsets
    ``Memcpy ...`` and ``Memset ...``."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "kernel"


class Trace:
    """Device intervals (ns, on the host's clock) inside the window, and the
    host's events for naming the idle gaps."""

    def __init__(self, events, window_name: str = WINDOW):
        dev: List[Tuple[int, int, str, str]] = []
        host: List[Tuple[int, int, str]] = []
        window = None
        for e in events:
            name = e.name()
            if e.is_user_annotation() and name == window_name:
                window = (e.start_ns(), e.end_ns())
            if str(e.device_type()).endswith("CUDA"):
                if e.is_user_annotation() or name == window_name \
                        or name.startswith("ProfilerStep"):
                    continue
                dev.append((e.start_ns(), e.end_ns(), name, _kind(name)))
            else:
                host.append((e.start_ns(), e.end_ns(), name))
        if window is None:
            raise RuntimeError("the trace lost the window's own span")
        self.start, self.end = window
        lo, hi = self.start, self.end
        self.device = [(max(s, lo), min(t, hi), n, k) for s, t, n, k in dev
                       if t > lo and s < hi]
        self.host = host

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self, match: Optional[Iterable[str]] = None
                       ) -> List[Tuple[int, int]]:
        """The union of the device intervals (of the ops whose name holds
        one of ``match``, if given), sorted."""
        pats = None if match is None else tuple(match)
        spans = sorted((s, t) for s, t, n, _ in self.device
                       if pats is None or any(p in n for p in pats))
        out: List[List[int]] = []
        for s, t in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def busy_s(self, match: Optional[Iterable[str]] = None) -> float:
        return sum(t - s for s, t in self.busy_intervals(match)) / 1e9

    def count(self, match: Optional[Iterable[str]] = None,
              kind: Optional[str] = None) -> int:
        """Device ops (of an activity ``kind`` such as "kernel", if given)
        whose name holds one of ``match``."""
        return sum(1 for _, _, n, k in self.device
                   if (kind is None or k == kind)
                   and (match is None or any(p in n for p in match)))

    def per_name(self) -> dict:
        """{device op name: (launches, seconds)}."""
        out: dict = {}
        for s, t, n, _ in self.device:
            c, sec = out.get(n, (0, 0.0))
            out[n] = (c + 1, sec + (t - s) / 1e9)
        return out

    def breakdown(self) -> dict:
        """The device ops that took most time, and the longest idle gaps,
        each named by the innermost host event under its midpoint."""
        ops = sorted(((n, sec) for n, (_, sec) in self.per_name().items()),
                     key=lambda x: -x[1])[:TOP]
        busy = self.busy_intervals()
        edges = [self.start] + [e for s, t in busy for e in (s, t)] \
            + [self.end]
        gaps = sorted(((edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]),
                      key=lambda g: g[0] - g[1])[:TOP]
        starts = np.array([h[0] for h in self.host], dtype=np.int64)
        ends = np.array([h[1] for h in self.host], dtype=np.int64)
        named = []
        for s, t in gaps:
            mid = (s + t) // 2
            under = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(under):
                i = under[np.argmin(ends[under] - starts[under])]
                label = self.host[i][2]
            else:
                label = "no host event"
            named.append([label[:200], (t - s) / 1e9])
        return {"device_ops": [[n[:200], sec] for n, sec in ops],
                "idle_gaps": named}

    def whole_per_call(self, calls: int) -> bool:
        """Every device op came a whole number of times per call."""
        return calls > 0 and bool(self.device) and all(
            c % calls == 0 for c, _ in self.per_name().values())


def traced(window: Callable[[], Optional[int]], pad: float = 0.02):
    """Run ``window()`` under the profiler; returns (its result, Trace).
    ``window()`` returns the calls it made, for the whole-launch check, or
    None where calls differ from one another (an open loop)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, \
        schedule

    for attempt in range(ATTEMPTS):
        p = pad * 2 ** attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(p)
            prof.step()
            time.sleep(p)
            with record_function(WINDOW):
                result = window()
                torch.cuda.synchronize()
            time.sleep(p)
            prof.step()
        trace = Trace(prof.profiler.kineto_results.events())
        if result is None or trace.whole_per_call(result):
            return result, trace
        print(f"portbench: trace {attempt + 1} dropped records, taken again "
              f"with a pad of {2 * p:.2f} s", file=sys.stderr)
    raise RuntimeError("the profiler keeps dropping records")
