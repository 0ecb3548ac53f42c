"""Python client for the pose daemon (``cli/serve.py``), counterpart of
``bilinear_tpu/client.py`` (stdlib + numpy). Talks the daemon's
application/x-npy and application/x-npz wire formats.

    client = PoseClient("http://gpu-host:8900")
    poses_mm = client.lift(keypoints_2d)          # (N, 16, 2) -> (N, 16, 3)
    pose2d, pose3d = client.pose(frames)          # (N, H, W, 3)
    client.health()                               # dict
    client.reload()                               # hot-swap newest ckpt
"""
from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.request
from typing import Optional, Tuple

import numpy as np


class ServerError(RuntimeError):
    """Raised when the daemon answers with a non-2xx status; carries the
    HTTP status and the server's JSON error message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message


class PoseClient:
    """Stdlib HTTP client for PoseHTTPServer.

    ``timeout`` is per request, in seconds. A server that was not warmed
    builds its kernels at the first request; keep the default generous or
    warm the server first.

    ``busy_retries``: how many times to retry a 503 (the daemon's
    admission control saying "backlog full, retry later") before raising.
    Each retry sleeps the server's ``Retry-After`` header (or
    ``busy_backoff`` seconds when absent). Default 0 surfaces the 503
    immediately — opt in for batch/offline clients that should treat
    backpressure as flow control rather than failure.
    """

    def __init__(self, base_url: str, timeout: float = 120.0,
                 busy_retries: int = 0, busy_backoff: float = 1.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.busy_retries = busy_retries
        self.busy_backoff = busy_backoff

    # -------------------------------------------------------------- http
    def _request(
        self,
        path: str,
        body: Optional[bytes] = None,
        ctype: str = "application/json",
        method: Optional[str] = None,
    ) -> Tuple[bytes, str]:
        req = urllib.request.Request(
            self.base_url + path,
            data=body,
            headers={"Content-Type": ctype} if body is not None else {},
            method=method,
        )
        for attempt in range(self.busy_retries + 1):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return r.read(), r.headers.get("Content-Type", "")
            except urllib.error.HTTPError as e:
                raw = e.read()
                try:
                    message = json.loads(raw).get("error", raw.decode())
                except Exception:
                    message = raw.decode(errors="replace")
                if e.code == 503 and attempt < self.busy_retries:
                    try:
                        delay = float(
                            e.headers.get("Retry-After") or self.busy_backoff
                        )
                    except ValueError:
                        delay = self.busy_backoff
                    time.sleep(delay)
                    continue
                raise ServerError(e.code, message) from None
        raise AssertionError("unreachable")

    # ------------------------------------------------------------ routes
    def health(self) -> dict:
        out, _ = self._request("/healthz")
        return json.loads(out)

    def reload(self) -> dict:
        """Ask the daemon to hot-swap to the newest checkpoint now."""
        out, _ = self._request("/admin/reload", body=b"", method="POST")
        return json.loads(out)

    def lift(self, keypoints: np.ndarray) -> np.ndarray:
        """2D->3D lifting. keypoints (N, 16, 2) image-space px ->
        (N, 16, 3) mm, root-centered (npy wire format both ways)."""
        kp = np.ascontiguousarray(keypoints, np.float32)
        if kp.ndim != 3 or kp.shape[1:] != (16, 2):
            raise ValueError(f"keypoints must be (N, 16, 2), got {kp.shape}")
        buf = io.BytesIO()
        np.save(buf, kp, allow_pickle=False)
        out, _ = self._request(
            "/v1/lift", buf.getvalue(), "application/x-npy", method="POST"
        )
        mm = np.load(io.BytesIO(out), allow_pickle=False)
        return mm.reshape(kp.shape[0], 16, 3)

    def pose(
        self,
        frames: np.ndarray,
        centers: Optional[np.ndarray] = None,
        scales: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """frame->2D+3D through the End2End model. frames (N, H, W, 3)
        uint8 or float in [0, 1], (H, W) the served detector's (256 x 256;
        ViTPose's 256 x 192; the server refuses another); optional crop
        centres (N, 2) and scales (N,) in the reference's centre/scale
        convention (the server's default is the full frame,
        webcam.py:13-25). Returns (pose2d (N, 16, 2) px, pose3d (N, 16, 3)
        mm)."""
        f = np.ascontiguousarray(frames)
        if f.ndim != 4 or f.shape[-1] != 3:
            raise ValueError(f"frames must be (N, H, W, 3), got {f.shape}")
        arrays = {"frames": f}
        if centers is not None:
            arrays["centers"] = np.ascontiguousarray(centers, np.float32)
        if scales is not None:
            arrays["scales"] = np.ascontiguousarray(scales, np.float32)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        out, _ = self._request(
            "/v1/pose", buf.getvalue(), "application/x-npz", method="POST"
        )
        with np.load(io.BytesIO(out), allow_pickle=False) as z:
            return z["pose2d"], z["pose3d_mm"]
