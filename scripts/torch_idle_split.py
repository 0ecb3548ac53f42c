#!/usr/bin/env python3
"""Where a traced cell's device idles: one ``--trace 1`` window of a
``portbench`` cell, its device-idle time split by the innermost program
span (``portbench/spans.py::PROGRAM``) running on the host meanwhile,
"between calls" where none runs, and under each span by the innermost host
event of any kind (a torch op, a CUDA runtime call, the span itself):

    python3 scripts/torch_idle_split.py --workload pose_bulk.bf16 \\
        --seed N [--root ROOT]

ROOT (default: this checkout) is the checkout whose program and
``portbench/`` run, for instance a ``git archive`` of an earlier commit with
this checkout's ``portbench/`` laid over it, for a before/after in one
call. Prints one JSON line: the card, the traced window's own end-to-end
rate, the per-layer metrics of the cell, the split (seconds), its sum
against the window's idle time, and the ten longest gaps with the innermost
program span and host event at each one's midpoint. Needs a card; imports
nothing of JAX.
"""
import argparse
import json
import os
import sys


def innermost_split(lists, idle):
    """Seconds of the ``idle`` (start, end) intervals keyed by the tuple of
    the innermost interval's name in each of ``lists`` (lists of (start,
    end, name); of those covering a point the latest started is the
    innermost; None where none covers it)."""
    events = sorted((t, kind, li, k) for li, items in enumerate(lists)
                    for k, (s, e, _) in enumerate(items) if e > s
                    for t, kind in ((s, 1), (e, 0)))
    active = [[] for _ in lists]  # per list, indices in start order
    out = {}
    e = 0
    for gs, gt in sorted(idle):
        cursor = gs
        while cursor < gt:
            while e < len(events) and events[e][0] <= cursor:
                _, kind, li, k = events[e]
                if kind:
                    active[li].append(k)
                else:
                    active[li].remove(k)
                e += 1
            stop = gt if e == len(events) else min(gt, events[e][0])
            key = tuple(lists[li][a[-1]][2] if a else None
                        for li, a in enumerate(active))
            out[key] = out.get(key, 0) + (stop - cursor)
            cursor = stop
    return {k: v / 1e9 for k, v in out.items()}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("torch_idle_split: no CUDA card", file=sys.stderr)
        return 3
    from portbench import harness, run as prun

    prun.cache_dirs(root)
    run, traffic = harness.setup_run(args.workload, args.seed, args.seconds,
                                     True)
    harness.measure(run, traffic)
    out = dict(root=root, workload=args.workload, seed=args.seed,
               card=harness.power_limit())
    out.update(analyse(run))
    print(json.dumps(out), flush=True)
    traffic.release(run)
    return 0


def analyse(run) -> dict:
    """The split, the longest gaps and the cell's per-layer metrics of a
    traced ``portbench`` run."""
    from portbench import harness, spans

    t = run.trace
    busy = t.busy_intervals()
    edges = [t.start] + [x for s, e in busy for x in (s, e)] + [t.end]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    program = sorted(spans.clipped(t, spans.PROGRAM))
    calls = sorted(spans.clipped(t, ("e2e.predict", "lift.call")))
    host = sorted((max(s, t.start), min(e, t.end), n) for s, e, n in t.host
                  if e > t.start and s < t.end and n != "portbench.window")
    both = innermost_split([program, host], idle)
    split, by_op = {}, {}
    for (span, op), sec in both.items():
        span = span or "between calls"
        split[span] = split.get(span, 0.0) + sec
        ops = by_op.setdefault(span, {})
        ops[op or "no host event"] = ops.get(op or "no host event", 0) + sec

    def ranked(d, n=None):
        return dict(sorted(d.items(), key=lambda x: -x[1])[:n])

    split = ranked(split)
    by_op = {k: ranked(v, 8) for k, v in by_op.items()}
    gaps = sorted(idle, key=lambda g: g[0] - g[1])[:10]

    def at(mid, items):
        under = [(e - s, n) for s, e, n in items if s <= mid <= e]
        return min(under)[1] if under else None

    named = [{"s": (e - s) / 1e9,
              "program_span": at((s + e) // 2, program),
              "host_event": at((s + e) // 2, host),
              "inside_a_call": at((s + e) // 2, calls) is not None}
             for s, e in gaps]
    metrics = {}
    for m in harness.metrics_of(harness.manifest(), run.name, "per_layer"):
        v = harness.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = v
    return {"window_s": t.window_s,
            "idle_s": sum(e - s for s, e in idle) / 1e9,
            "split_sum_s": sum(split.values()), "e2e_of_window": run.e2e,
            "counters": run.counters, "metrics": metrics,
            "idle_split_s": split, "by_host_event": by_op,
            "longest_gaps": named}


if __name__ == "__main__":
    sys.exit(main())
