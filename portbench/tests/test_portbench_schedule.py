"""The open loop: the schedule from the seed, each request timed from its
due time, and a failed request counted as failed."""
from __future__ import annotations

import io
import multiprocessing
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from portbench.tests.conftest import SEED
from portbench.traffic import http_client

PARAMS = {"rate_per_s": 40.0, "sizes": [1, 8, 16],
          "size_probs": [0.5, 0.25, 0.25], "pool_frames": 64,
          "connections": 4}


def test_schedule_is_the_mix_in_a_seeded_order():
    due, sizes, firsts = http_client.schedule(SEED, PARAMS, 10.0)
    assert len(due) == 400
    assert np.all(np.diff(due) >= 0) and 0 <= due[0] and due[-1] < 10.0
    assert sorted(np.bincount(sizes)[[1, 8, 16]]) == [100, 100, 200]
    assert np.all(firsts % 16 == 0) and np.all(firsts + sizes <= 64)
    again = http_client.schedule(SEED, PARAMS, 10.0)
    other = http_client.schedule(SEED + 1, PARAMS, 10.0)
    assert all(np.array_equal(a, b) for a, b in zip(again, (due, sizes,
                                                            firsts)))
    assert not np.array_equal(other[0], due)
    assert sorted(other[1]) == sorted(sizes)  # same work, another order


def test_percentile_is_nearest_rank():
    assert http_client.percentile(list(range(1, 101)), 95) == 95
    assert http_client.percentile([5.0], 95) == 5.0


class _Slow(BaseHTTPRequestHandler):
    """Answers after ``DELAY`` seconds; every third request with a 500."""

    protocol_version = "HTTP/1.1"
    DELAY = 0.2
    count = 0
    lock = threading.Lock()

    def log_message(self, *args):
        pass

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers["Content-Length"]))
        with _Slow.lock:
            _Slow.count += 1
            n = _Slow.count
        time.sleep(self.DELAY)
        if n % 3 == 0:
            body, code = b"no", 500
        else:
            buf = io.BytesIO()
            np.savez(buf, pose2d=np.zeros((1, 16, 2), np.float32),
                     pose3d_mm=np.zeros((1, 16, 3), np.float32))
            body, code = buf.getvalue(), 200
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def slow_server():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()


def test_requests_are_timed_from_their_due_time(slow_server):
    """One connection and a 0.2 s server: requests queue in the client, so
    each waits for the one before; the latency counts that wait, and every
    third answer (a 500) is a failure."""
    params = dict(PARAMS, rate_per_s=10.0, connections=1, pool_frames=16)
    parent, child = multiprocessing.Pipe()
    t = threading.Thread(target=http_client.main,
                         args=(child, slow_server, SEED, params))
    t.start()
    assert parent.recv() == "ready"
    seconds = 1.0
    parent.send((time.monotonic() + 0.05, seconds, [0, 1]))
    got = parent.recv()
    t.join(timeout=30)
    assert not t.is_alive()
    n = len(got["due"])
    assert n == 10
    latency = got["done"] - got["due"]
    assert np.all(latency >= _Slow.DELAY * 0.9)
    # With one connection the last request waits behind the others.
    assert latency[-1] > (n * _Slow.DELAY - seconds) * 0.8
    assert np.all(got["sent"] >= got["due"] - 1e-3)
    assert int((~got["ok"]).sum()) == n // 3
    assert set(got["answers"]) <= {0, 1}
