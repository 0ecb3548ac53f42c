"""The program's spans in a traced window, for the readers of
``source: program_span`` metrics.

The program's spans are ``torch.profiler`` ranges (its
``utils/profiling.py::span``), so they arrive in ``Trace.host`` beside the
torch ops, on the clock of the device intervals. These functions clip
them to the window ``[trace.start, trace.end]`` and sum them by name. A
span's parent is the span enclosing it on its thread, and its self time
is its duration less the union of the program's other spans inside it.
Every function returns None where the trace holds no span of the name
asked for (a program without them).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

# The names these readers know; the program keeps them in ``SPANS`` of
# serving.py and ops/resmodule.py.
PROGRAM = ("e2e.predict", "e2e.h2d", "e2e.forward", "e2e.d2h", "lift.call",
           "k3.forward", "k4.backward", "batcher.dispatch")


def clipped(trace, names: Iterable[str]) -> List[Tuple[int, int, str]]:
    """(start, end, name) in ns of the host events named in ``names``,
    clipped to the window; those wholly outside it are left out."""
    names = set(names)
    lo, hi = trace.start, trace.end
    return [(max(s, lo), min(t, hi), n) for s, t, n in trace.host
            if n in names and t > lo and s < hi]


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def total_s(trace, name: str) -> Optional[float]:
    """Summed duration of the spans named ``name``, in seconds."""
    spans = clipped(trace, (name,))
    if not spans:
        return None
    return sum(t - s for s, t, _ in spans) / 1e9


def mean_s(trace, name: str) -> Optional[float]:
    """Mean duration of the spans named ``name``, in seconds."""
    spans = clipped(trace, (name,))
    if not spans:
        return None
    return sum(t - s for s, t, _ in spans) / len(spans) / 1e9


def self_s(trace, name: str) -> Optional[float]:
    """Summed self time of the spans named ``name``, in seconds: each
    one's duration less the union of the other program spans that lie
    inside it (its children, theirs, and children that overlap one
    another)."""
    spans = clipped(trace, PROGRAM)
    own = [i for i, sp in enumerate(spans) if sp[2] == name]
    if not own:
        return None
    total = 0
    for i in own:
        s, t, _ = spans[i]
        inner = [(a, b) for j, (a, b, _) in enumerate(spans)
                 if j != i and s <= a and b <= t]
        total += (t - s) - union_ns(inner)
    return total / 1e9


def outside_s(trace, name: str) -> Optional[float]:
    """Window time outside every span named ``name``, in seconds."""
    spans = clipped(trace, (name,))
    if not spans:
        return None
    covered = union_ns((s, t) for s, t, _ in spans)
    return (trace.end - trace.start - covered) / 1e9
