"""Network serving: a dynamic-batching HTTP front-end over the lifting and
End2End servers (counterpart of ``bilinear_tpu/serving_http.py``).

- ``DynamicBatcher`` coalesces concurrent requests into one backend call:
  the first arrival opens a batching window of ``max_delay_ms`` (or until
  ``max_rows`` are waiting); everything queued in the window rides the same
  kernel launch. Padding to the End2End batch sizes is the End2End
  server's job (``End2EndServer._chunks``), so the batcher only
  concatenates and scatters.
- ``PoseHTTPServer`` exposes the service over HTTP (stdlib only):
    GET  /healthz         -> JSON status (kind, epoch, counters)
    GET  /metrics         -> Prometheus text
    POST /v1/lift         -> 2D->3D lifting (JSON or .npy body)
    POST /v1/pose         -> frames->2D+3D, End2End (.npz body)
    POST /admin/reload    -> hot-swap to the newest checkpoint(s)
  and polls the run dir(s) for new checkpoints every ``reload_every`` s
  (in-flight batches finish on the old weights). A route whose model is
  not loaded answers 404.

The dispatcher's work on one batch (joining the riders, the backend call,
scattering the answers) is the span ``batcher.dispatch``
(``utils/profiling.py::span``), over the interval ``dispatch_seconds``
counts. It runs on the dispatcher thread, so a profile shows it when it
records every thread (``profile_all_threads``).
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence

import numpy as np

from bilinear_tpu_torch.ops.lifting_int8 import GROUP
from bilinear_tpu_torch.serving import check_frames, default_box
from bilinear_tpu_torch.utils.profiling import span

SPANS = ("batcher.dispatch",)

# ---------------------------------------------------------------------------
# Dynamic batching
# ---------------------------------------------------------------------------


class ModelNotLoaded(Exception):
    """A route's model was not configured on this daemon (-> HTTP 404)."""


class ServerBusy(Exception):
    """The batcher's pending-row budget is exhausted (-> HTTP 503)."""


class BackendError(Exception):
    """The backend failed on an already-validated batch (-> HTTP 500).

    By submit time a request has passed all shape/format validation, so an
    exception out of the dispatcher — even a ValueError from a misconfigured
    backend — is the server's fault and is shared by every co-batched rider;
    answering 400 would blame well-formed requests for a server incident."""


class _Pending:
    __slots__ = ("arrays", "n_rows", "taken", "pieces", "event", "result",
                 "error", "submitted")

    def __init__(self, arrays: Sequence[np.ndarray]):
        self.submitted = time.monotonic()
        self.arrays = arrays
        self.n_rows = int(arrays[0].shape[0])
        self.taken = 0  # rows already claimed by dispatches (split requests)
        self.pieces: List[tuple] = []  # (start, outs) per completed slice
        self.event = threading.Event()
        self.result: Optional[tuple] = None
        self.error: Optional[BaseException] = None

    def complete_piece(self, start: int, outs: tuple) -> None:
        """Record one dispatched slice's outputs; assemble + signal when the
        whole request is answered. Called only from the dispatcher thread."""
        self.pieces.append((start, outs))
        done = sum(o[0].shape[0] for _, o in self.pieces)
        if done >= self.n_rows:
            self.pieces.sort(key=lambda t: t[0])
            n_out = len(self.pieces[0][1])
            if len(self.pieces) == 1:
                self.result = self.pieces[0][1]
            else:
                self.result = tuple(
                    np.concatenate([o[i] for _, o in self.pieces], axis=0)
                    for i in range(n_out)
                )
            self.event.set()


class DynamicBatcher:
    """Coalesce concurrent requests into single backend calls.

    ``fn(*arrays) -> tuple_of_arrays``: every input/output shares the
    leading (row) axis. A dedicated dispatcher thread owns all backend
    calls, so device dispatch is serialized regardless of how many HTTP
    handler threads are submitting.
    """

    def __init__(
        self,
        fn: Callable[..., tuple],
        n_inputs: int,
        max_delay_ms: float = 2.0,
        max_rows: int = 256,
        max_pending_rows: int = 8192,
        coerce: Optional[dict] = None,
    ):
        """``max_pending_rows`` bounds the queue (admission control): a
        request that would push the total queued rows past it is rejected
        with ServerBusy instead of growing the backlog without bound.

        ``coerce``: optional ``{input_index: fn(list_of_arrays) -> list}``
        applied before that input is concatenated across riders: the hook
        that gives a mixed u8/f32 frame batch one dtype without converting
        every request."""
        self._fn = fn
        self._n_inputs = n_inputs
        self._coerce = coerce or {}
        self._max_delay = max_delay_ms / 1000.0
        self._max_rows = max_rows
        self._max_pending = max_pending_rows
        self._pending_rows = 0
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._stopped = False
        self.batches_dispatched = 0
        self.rows_served = 0
        self.rows_rejected = 0
        self.dispatch_seconds = 0.0
        # Requests whose first rows reached a dispatch, and their summed
        # wait from submit to the start of that dispatch.
        self.requests_dispatched = 0
        self.queue_wait_seconds = 0.0
        self._thread = threading.Thread(
            target=self._run, name="batcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- client
    def submit(self, *arrays: np.ndarray) -> tuple:
        """Block until the coalesced batch containing these rows returns;
        raises whatever the backend raised."""
        if len(arrays) != self._n_inputs:
            raise ValueError(
                f"expected {self._n_inputs} arrays, got {len(arrays)}"
            )
        n = int(arrays[0].shape[0])
        if any(int(a.shape[0]) != n for a in arrays):
            raise ValueError("inputs disagree on the row count")
        req = _Pending(arrays)
        with self._lock:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            if self._pending_rows + n > self._max_pending:
                self.rows_rejected += n
                raise ServerBusy(
                    f"{self._pending_rows} rows already queued "
                    f"(limit {self._max_pending}); retry later"
                )
            self._pending_rows += n
            self._queue.append(req)
            self._wakeup.notify()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._wakeup.notify()
        self._thread.join(timeout=5)

    # --------------------------------------------------------- dispatcher
    def _take_batch(self) -> List[tuple]:
        """Wait for the first request, keep the window open for max_delay_ms
        (or until max_rows are queued), then take AT MOST max_rows as
        (pending, start, n) slices — splitting a large request across
        dispatches. Without the cap+split, one 4096-row bulk body turns
        every co-queued small request into a convoy rider of a mega-dispatch;
        with it, concurrent bulk clients interleave at max_rows
        granularity."""
        with self._lock:
            while not self._queue and not self._stopped:
                self._wakeup.wait()
            if self._stopped and not self._queue:
                return []
            deadline = time.monotonic() + self._max_delay
            while True:
                rows = sum(r.n_rows - r.taken for r in self._queue)
                left = deadline - time.monotonic()
                if rows >= self._max_rows or left <= 0 or self._stopped:
                    break
                self._wakeup.wait(timeout=left)
            # Round-robin shares across queued requests (not FIFO fill):
            # a small request always gets a share of the NEXT dispatch even
            # while a 4096-row bulk body is mid-flight, and N concurrent
            # bulk clients progress in parallel instead of in series.
            slices: List[tuple] = []
            space = self._max_rows
            while self._queue and space > 0:
                share = max(1, space // len(self._queue))
                for r in list(self._queue):
                    if space <= 0:
                        break
                    n = min(r.n_rows - r.taken, share, space)
                    if n <= 0:
                        continue
                    slices.append((r, r.taken, n))
                    r.taken += n
                    space -= n
                    self._pending_rows -= n
                self._queue = [r for r in self._queue if r.taken < r.n_rows]
            return slices

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return
            try:
                t0 = time.monotonic()
                for r, start, _ in batch:
                    if start == 0:  # the request's first slice
                        self.requests_dispatched += 1
                        self.queue_wait_seconds += t0 - r.submitted
                with span("batcher.dispatch"):
                    joined = []
                    for i in range(self._n_inputs):
                        arrs = [r.arrays[i][start:start + n]
                                for r, start, n in batch]
                        if i in self._coerce:
                            arrs = self._coerce[i](arrs)
                        joined.append(np.concatenate(arrs, axis=0))
                    joined = tuple(joined)
                    outs = self._fn(*joined)
                    if not isinstance(outs, tuple):
                        outs = (outs,)
                    outs = tuple(np.asarray(o) for o in outs)
                    offset = 0
                    for r, start, n in batch:
                        piece = tuple(o[offset:offset + n] for o in outs)
                        r.complete_piece(start, piece)
                        offset += n
                self.batches_dispatched += 1
                self.rows_served += offset
                self.dispatch_seconds += time.monotonic() - t0
            except BaseException as e:  # propagate to every waiter; a
                # multi-slice request fails wholesale (partial results are
                # never returned)
                for r, _, _ in batch:
                    r.error = e
            finally:
                for r, _, _ in batch:
                    if r.error is not None:
                        r.event.set()


# ---------------------------------------------------------------------------
# HTTP front-end
# ---------------------------------------------------------------------------


def _submit(batcher: DynamicBatcher, *arrays: np.ndarray) -> tuple:
    """Route batcher/backend failures to the right HTTP class: ModelNotLoaded
    (404) and ServerBusy (503) pass through; anything else becomes
    BackendError so the handler's ValueError->400 mapping cannot blame the
    client for a server-side failure (see BackendError)."""
    try:
        return batcher.submit(*arrays)
    except (ModelNotLoaded, ServerBusy):
        raise
    except Exception as e:
        raise BackendError(f"{type(e).__name__}: {e}") from e


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _load_npy(body: bytes) -> np.ndarray:
    """np.load with every decode failure (EOFError on empty bodies,
    magic-string ValueErrors, OSError on truncation) mapped to ValueError
    so the handler answers 400, not 500."""
    try:
        return np.load(io.BytesIO(body), allow_pickle=False)
    except Exception as e:
        raise ValueError(f"undecodable npy body: {e}") from None


def _load_npz(body: bytes):
    try:
        z = np.load(io.BytesIO(body), allow_pickle=False)
        z.files  # forces the zip directory read
        return z
    except Exception as e:
        raise ValueError(f"undecodable npz body: {e}") from None


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def coerce_frames(arrs: List[np.ndarray]) -> List[np.ndarray]:
    """One dtype for a coalesced frame batch. A batch of one dtype keeps it
    (u8 ships a quarter of the bytes to the device); in a mixed u8/f32
    batch every u8 rider becomes f32 / 255, the value the device computes
    for it, and is not left to np.concatenate, which would feed 0-255
    values to the [0, 1] model."""
    if len({a.dtype for a in arrs}) == 1:
        return arrs
    return [a.astype(np.float32) / np.float32(255.0) if a.dtype == np.uint8
            else a.astype(np.float32) for a in arrs]


class _Handler(BaseHTTPRequestHandler):
    # Populated by PoseHTTPServer.
    service: "PoseHTTPServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route into the service logger
        if self.service.logger is not None:
            self.service.logger.debug("http: " + fmt % args)

    # ---------------------------------------------------------- plumbing
    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        if length > self.service.max_body_bytes:
            raise ValueError(
                f"body of {length} bytes exceeds the "
                f"{self.service.max_body_bytes}-byte limit"
            )
        return self.rfile.read(length)

    def _send(self, code: int, payload: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _fail(self, code: int, message: str) -> None:
        self._send_json(code, {"error": message})

    # ------------------------------------------------------------ routes
    def do_GET(self):  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._send_json(200, self.service.health())
        elif self.path == "/metrics":
            self._send(
                200,
                self.service.metrics_text().encode(),
                "text/plain; version=0.0.4",
            )
        else:
            self._fail(404, f"no route {self.path}")

    def do_POST(self):  # noqa: N802
        try:
            body = self._body()
        except ValueError as e:
            # The oversized body was never read off the socket; a keep-alive
            # client's next request would be parsed out of its bytes.
            self.close_connection = True
            self._fail(413, str(e))
            return
        try:
            if self.path == "/v1/lift":
                self._lift(body)
            elif self.path == "/v1/pose":
                self._pose(body)
            elif self.path == "/admin/reload":
                self._send_json(200, self.service.reload_now())
            else:
                self._fail(404, f"no route {self.path}")
        except ModelNotLoaded as e:
            self._fail(404, str(e))
        except ServerBusy as e:
            payload = json.dumps({"error": str(e)}).encode()
            self.send_response(503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(payload)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self._fail(400, f"bad request: {e}")
        except Exception as e:  # backend failure
            self._fail(500, f"{type(e).__name__}: {e}")

    def _lift(self, body: bytes) -> None:
        ctype = self.headers.get("Content-Type", "application/json")
        as_npy = ctype.startswith("application/x-npy")
        if as_npy:
            kp = _load_npy(body)
        else:
            kp = np.asarray(
                json.loads(body.decode())["keypoints"], np.float32
            )
        if kp.ndim != 3 or kp.shape[1:] != (16, 2):
            raise ValueError(f"keypoints must be (N, 16, 2), got {kp.shape}")
        (mm,) = _submit(self.service.lift_batcher, kp.astype(np.float32))
        if as_npy:
            self._send(200, _npy_bytes(mm), "application/x-npy")
        else:
            self._send_json(200, {"poses_mm": mm.tolist()})

    def _pose(self, body: bytes) -> None:
        if self.service.end2end is None:
            raise ModelNotLoaded("no end2end model is loaded")
        # The served detector's (H, W): 256 x 256, ViTPose's 256 x 192.
        size = self.service.end2end.input_size
        with _load_npz(body) as z:
            frames = z["frames"]
            n = frames.shape[0] if frames.ndim else 0
            box = default_box(size, n)
            centers = (z["centers"].astype(np.float32) if "centers" in z
                       else box[0])
            scales = (z["scales"].astype(np.float32) if "scales" in z
                      else box[1])
        check_frames(frames, size)
        # Validate every array BEFORE submit(): a malformed request inside
        # the batcher would fail the whole coalesced batch.
        if centers.shape != (n, 2):
            raise ValueError(f"centers must be ({n}, 2), got {centers.shape}")
        if scales.shape != (n,):
            raise ValueError(f"scales must be ({n},), got {scales.shape}")
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32)
        pose2d, pose3d = _submit(self.service.pose_batcher, frames, centers,
                                 scales)
        self._send(200, _npz_bytes(pose2d=pose2d, pose3d_mm=pose3d),
                   "application/x-npz")


class PoseHTTPServer:
    """Serve a LiftingServer and/or an End2EndServer over HTTP with dynamic
    batching and periodic checkpoint hot-reload.

    ``lifting`` / ``end2end``: the serving.py servers; either may be None
    (its route then answers 404), not both. ``reload_every``: seconds
    between run-dir polls (0 disables the poll thread; POST /admin/reload
    still works).
    """

    def __init__(
        self,
        lifting=None,
        end2end=None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_delay_ms: float = 2.0,
        max_rows: int = 256,
        max_pending_rows: int = 8192,
        reload_every: float = 0.0,
        max_body_bytes: int = 256 * 1024 * 1024,
        logger=None,
    ):
        if lifting is None and end2end is None:
            raise ValueError("need at least one of lifting/end2end")
        self.lifting = lifting
        self.end2end = end2end
        self.logger = logger
        self.max_body_bytes = max_body_bytes
        self.started = time.time()
        self._reload_lock = threading.Lock()
        self._reload_every = reload_every
        self._stop_poll = threading.Event()

        def lift_fn(kp):
            if self.lifting is None:
                raise ModelNotLoaded("no lifting model is loaded")
            mm = self.lifting.lift(kp)
            return (mm.detach().cpu().numpy().astype(np.float32, copy=False),)

        def pose_fn(frames, centers, scales):
            if self.end2end is None:
                raise ModelNotLoaded("no end2end model is loaded")
            p2, p3 = self.end2end.predict(frames, centers, scales)
            return np.asarray(p2, np.float32), np.asarray(p3, np.float32)

        self.lift_batcher = DynamicBatcher(
            lift_fn, n_inputs=1, max_delay_ms=max_delay_ms,
            max_rows=max_rows, max_pending_rows=max_pending_rows,
        )
        self.pose_batcher = DynamicBatcher(
            pose_fn, n_inputs=3, max_delay_ms=max_delay_ms,
            max_rows=max_rows, max_pending_rows=max_pending_rows,
            coerce={0: coerce_frames},
        )

        handler = type("BoundHandler", (_Handler,), {"service": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="http", daemon=True
        )
        self._poll_thread = None

    def warm(self, pose_dtypes=("uint8",)) -> dict:
        """Build and load the kernels before the first request. Lifting:
        the forward at every row count on the dispatch grid (multiples of
        the int8 path's scale group up to this server's max_rows, which a
        capped dispatch never exceeds). Pose: each End2End batch size per
        frame dtype of ``pose_dtypes`` ("uint8"/"u8", "float32")."""
        out = {}
        if self.lifting is not None:
            top = self.lift_batcher._max_rows
            grid = list(range(GROUP, top + 1, GROUP))
            if not grid or grid[-1] != top:
                grid.append(top)
            out["lift_rows"] = self.lifting.warm(grid)
        if self.end2end is not None:
            out["pose"] = self.end2end.warm(pose_dtypes)
        return out

    # ------------------------------------------------------------ control
    def start(self) -> None:
        self._serve_thread.start()
        if self._reload_every > 0:
            self._poll_thread = threading.Thread(
                target=self._poll_reload, name="reload-poll", daemon=True
            )
            self._poll_thread.start()
        if self.logger is not None:
            self.logger.info(
                "serving on http://%s:%d (lift=%s, pose=%s)", self.host,
                self.port, self.lifting is not None,
                self.end2end is not None)

    def stop(self) -> None:
        self._stop_poll.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self.lift_batcher.stop()
        self.pose_batcher.stop()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)

    def serve_forever(self) -> None:
        """Blocking variant for the CLI: runs until SIGTERM/SIGINT, then
        drains (in-flight batches finish; new submits are refused)."""
        import signal

        done = threading.Event()

        def handler(signum, frame):
            if self.logger is not None:
                self.logger.info(
                    "received %s, shutting down", signal.Signals(signum).name
                )
            done.set()

        prev = {
            s: signal.signal(s, handler)
            for s in (signal.SIGTERM, signal.SIGINT)
        }
        self.start()
        try:
            done.wait()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
            for s, h in prev.items():
                signal.signal(s, h)

    # ------------------------------------------------------------- status
    def _routes(self):
        """(route, batcher, served model) of each loaded route."""
        out = []
        if self.lifting is not None:
            out.append(("lift", self.lift_batcher, self.lifting))
        if self.end2end is not None:
            out.append(("pose", self.pose_batcher, self.end2end))
        return out

    def health(self) -> dict:
        out = {
            "status": "ok",
            "uptime_s": round(time.time() - self.started, 3),
            "lift": None,
            "pose": None,
        }
        for name, b, server in self._routes():
            out[name] = {"epoch": server.epoch,
                         "batches": b.batches_dispatched,
                         "rows": b.rows_served}
        return out

    def metrics_text(self) -> str:
        """Prometheus text exposition (0.0.4) of the daemon's counters."""
        lines = [
            "# HELP bilinear_uptime_seconds Daemon uptime.",
            "# TYPE bilinear_uptime_seconds gauge",
            f"bilinear_uptime_seconds {time.time() - self.started:.3f}",
            "# HELP bilinear_rows_served_total Rows returned per route.",
            "# TYPE bilinear_rows_served_total counter",
            "# HELP bilinear_batches_total Device dispatches per route.",
            "# TYPE bilinear_batches_total counter",
            "# HELP bilinear_rows_rejected_total Rows refused with 503.",
            "# TYPE bilinear_rows_rejected_total counter",
            "# HELP bilinear_dispatch_seconds_total Backend time per route.",
            "# TYPE bilinear_dispatch_seconds_total counter",
            "# HELP bilinear_model_epoch Checkpoint epoch being served.",
            "# TYPE bilinear_model_epoch gauge",
            "# HELP bilinear_queue_wait_seconds_total Seconds requests "
            "waited from submit to their first dispatch.",
            "# TYPE bilinear_queue_wait_seconds_total counter",
            "# HELP bilinear_requests_total Requests dispatched per route.",
            "# TYPE bilinear_requests_total counter",
            "# HELP bilinear_rows_padded_total Zero rows added to fill a "
            "batch size.",
            "# TYPE bilinear_rows_padded_total counter",
        ]
        for name, b, server in self._routes():
            tag = f'{{route="{name}"}}'
            lines += [
                f"bilinear_rows_served_total{tag} {b.rows_served}",
                f"bilinear_batches_total{tag} {b.batches_dispatched}",
                f"bilinear_rows_rejected_total{tag} {b.rows_rejected}",
                f"bilinear_dispatch_seconds_total{tag} "
                f"{b.dispatch_seconds:.6f}",
                f"bilinear_model_epoch{tag} {server.epoch}",
                f"bilinear_queue_wait_seconds_total{tag} "
                f"{b.queue_wait_seconds:.6f}",
                f"bilinear_requests_total{tag} {b.requests_dispatched}",
            ]
        if self.end2end is not None:
            lines.append(f'bilinear_rows_padded_total{{route="pose"}} '
                         f"{self.end2end.frames_padded}")
        return "\n".join(lines) + "\n"

    # ---------------------------------------------------------- hot reload
    def reload_now(self) -> dict:
        """Check the run dir(s) for newer checkpoints; swap where found.
        Each swap is one reference assignment, so in-flight batches finish
        on the old weights."""
        with self._reload_lock:
            reloaded = False
            if self.end2end is not None:
                reloaded = bool(self.end2end.reload()) or reloaded
            if self.lifting is not None:
                reloaded = bool(self.lifting.reload()) or reloaded
            return {
                "reloaded": reloaded,
                "epoch": self.end2end.epoch if self.end2end else None,
                "lift_epoch": self.lifting.epoch if self.lifting else None,
            }

    def _poll_reload(self) -> None:
        while not self._stop_poll.wait(self._reload_every):
            try:
                result = self.reload_now()
                if result["reloaded"] and self.logger is not None:
                    self.logger.info("hot-reloaded checkpoint %s", " ".join(
                        f"{k}={result[k]}" for k in ("epoch", "lift_epoch")
                        if result[k] is not None))
            except Exception as e:  # keep polling through transient errors
                if self.logger is not None:
                    self.logger.warning("reload poll failed: %s", e)
