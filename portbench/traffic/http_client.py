"""The open-loop client of the HTTP cells, run in a process of its own. It
imports numpy and the standard library only.

The schedule comes from the seed and the workload alone: ``rate_per_s``
times the window's seconds requests, their sizes in exactly the mix's
proportions in a seeded order, their due times the order statistics of a
uniform draw over the window (a Poisson process given its count), and each
request's frames a contiguous run of the seeded pool. Every request is
timed from its due time to the last byte of its answer; one that fails, or
is still open a minute after the window, counts as failed, with the
latency up to the moment it was given up.
"""
from __future__ import annotations

import http.client
import io
import queue
import threading
import time
from typing import List

import numpy as np

from portbench import seeds

GRACE_S = 60.0


def schedule(seed: int, params: dict, seconds: float):
    """(due times in s from the start, sizes, first frames), one per
    request."""
    n = max(1, int(round(params["rate_per_s"] * seconds)))
    r = seeds.rng(seed, "arrivals")
    due = np.sort(r.uniform(0.0, seconds, n))
    sizes = np.concatenate([np.full(int(round(p * n)), s) for s, p in
                            zip(params["sizes"], params["size_probs"])])
    sizes = np.resize(sizes, n)
    r.shuffle(sizes)
    step = max(params["sizes"])
    slots = (params["pool_frames"] - step) // step + 1
    firsts = r.integers(0, slots, n) * step
    return due, sizes.astype(int), firsts.astype(int)


def bodies(pool: np.ndarray, params: dict) -> dict:
    """One .npz body per (first frame, size) the schedule can ask for."""
    out = {}
    step = max(params["sizes"])
    for first in range(0, params["pool_frames"] - step + 1, step):
        for size in params["sizes"]:
            buf = io.BytesIO()
            np.savez(buf, frames=pool[first:first + size])
            out[(first, size)] = buf.getvalue()
    return out


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    s = sorted(values)
    return s[max(0, int(np.ceil(q / 100.0 * len(s))) - 1)]


def main(conn, port: int, seed: int, params: dict) -> None:
    """Make the bodies, say "ready" on ``conn``, wait for (start time,
    seconds, requests to keep), send the window's requests, and send back
    (due, sent, done, ok) per request and the answers of the kept ones."""
    pool = seeds.frame_pool(seed, params["pool_frames"])
    payload = bodies(pool, params)
    conn.send("ready")
    t0, seconds, keep = conn.recv()
    due, sizes, firsts = schedule(seed, params, seconds)
    n = len(due)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    ok = np.zeros(n, bool)
    answers = {}
    keep_set = set(keep)
    todo: "queue.Queue" = queue.Queue()

    def worker() -> None:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=GRACE_S)
        while True:
            i = todo.get()
            if i is None:
                c.close()
                return
            sent[i] = time.monotonic() - t0
            try:
                c.request("POST", "/v1/pose",
                          body=payload[(firsts[i], sizes[i])],
                          headers={"Content-Type": "application/x-npz"})
                resp = c.getresponse()
                body = resp.read()
                done[i] = time.monotonic() - t0
                ok[i] = resp.status == 200
                if ok[i] and i in keep_set:
                    z = np.load(io.BytesIO(body))
                    answers[i] = (z["pose2d"], z["pose3d_mm"])
            except (OSError, http.client.HTTPException):
                done[i] = time.monotonic() - t0
                c.close()
                c = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=GRACE_S)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(params["connections"])]
    for t in threads:
        t.start()
    for i in range(n):
        wait = t0 + due[i] - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        todo.put(i)
    for _ in threads:
        todo.put(None)
    deadline = t0 + seconds + GRACE_S
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    gave_up = time.monotonic() - t0
    done = np.where(np.isnan(done), gave_up, done)
    conn.send({"due": due, "sent": sent, "done": done, "ok": ok,
               "sizes": sizes, "firsts": firsts, "answers": answers})
    conn.close()
