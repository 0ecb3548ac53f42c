"""Human3.6M camera calibration: loading, projection and unprojection
(counterpart of ``bilinear_tpu/data/camera.py``).

Per camera the reference ships four plain-text files,
``{camera}_{c,f,k,p}.txt``: principal point, focal lengths, three radial and
two tangential distortion coefficients. The model (the standard H36M one):

    x = X/Z, y = Y/Z, r2 = x^2 + y^2
    radial = 1 + k1 r2 + k2 r2^2 + k3 r2^3
    tan    = p1*y + p2*x
    x' = x*(radial + tan) + p2*r2 ;  y' = y*(radial + tan) + p1*r2
    u = f_x x' + c_x ;  v = f_y y' + c_y

``project`` runs on tensors of any device and ``project_np`` on the host,
both in the operation order of JAX's ``_distort``; ``project_np`` equals
JAX's bit for bit (numpy on both sides). On the card ``project`` may differ
from it by FMA contraction. ``unproject`` inverts the distortion with
JAX's 10-step fixed-point iteration.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

H36M_CAMERA_IDS = ["54138969", "55011271", "58860488", "60457274"]


@dataclass(frozen=True)
class Camera:
    f: np.ndarray  # (2,) focal lengths (px)
    c: np.ndarray  # (2,) principal point (px)
    k: np.ndarray  # (3,) radial distortion
    p: np.ndarray  # (2,) tangential distortion
    name: str = ""


def load_camera(calibration_dir: str, camera_id: str) -> Camera:
    def read(suffix):
        return np.loadtxt(
            os.path.join(calibration_dir, f"{camera_id}_{suffix}.txt")
        ).reshape(-1)

    return Camera(
        f=read("f").astype(np.float32),
        c=read("c").astype(np.float32),
        k=read("k").astype(np.float32),
        p=read("p").astype(np.float32),
        name=camera_id,
    )


def load_all_cameras(calibration_dir: str) -> Dict[str, Camera]:
    return {cid: load_camera(calibration_dir, cid) for cid in H36M_CAMERA_IDS}


def _consts(camera: Camera, like: torch.Tensor):
    """(f, c, k, p) as f32 tensors on ``like``'s device."""
    return tuple(torch.as_tensor(np.asarray(a, np.float32),
                                 device=like.device)
                 for a in (camera.f, camera.c, camera.k, camera.p))


def _distort(xy: torch.Tensor, k: torch.Tensor, p: torch.Tensor
             ) -> torch.Tensor:
    r2 = xy.square().sum(dim=-1, keepdim=True)
    radial = 1.0 + k[0] * r2 + k[1] * r2 ** 2 + k[2] * r2 ** 3
    tan = p[0] * xy[..., 1:2] + p[1] * xy[..., 0:1]
    extra = torch.cat([p[1] * r2, p[0] * r2], dim=-1)
    return xy * (radial + tan) + extra


def project(points_cam: torch.Tensor, camera: Camera) -> torch.Tensor:
    """(..., 3) camera-space mm -> (..., 2) pixels, with distortion, on
    the points' device."""
    pts = torch.as_tensor(points_cam, dtype=torch.float32)
    f, c, k, p = _consts(camera, pts)
    xy = pts[..., :2] / pts[..., 2:3]
    return _distort(xy, k, p) * f + c


def project_np(points_cam: np.ndarray, camera: Camera) -> np.ndarray:
    """Numpy mirror of :func:`project`, for the host-side bin producers."""
    k = np.asarray(camera.k, np.float32)
    p = np.asarray(camera.p, np.float32)
    pts = np.asarray(points_cam, np.float32)
    xy = pts[..., :2] / pts[..., 2:3]
    r2 = np.sum(np.square(xy), axis=-1, keepdims=True)
    radial = 1.0 + k[0] * r2 + k[1] * r2**2 + k[2] * r2**3
    tan = p[0] * xy[..., 1:2] + p[1] * xy[..., 0:1]
    extra = np.concatenate([p[1] * r2, p[0] * r2], axis=-1)
    distorted = xy * (radial + tan) + extra
    return distorted * np.asarray(camera.f, np.float32) + np.asarray(
        camera.c, np.float32
    )


def unproject(pixels: torch.Tensor, depth: torch.Tensor, camera: Camera,
              iters: int = 10) -> torch.Tensor:
    """(..., 2) pixels + (...,) depth mm -> (..., 3) camera-space mm.

    Undistorts by fixed-point iteration: xy <- (target - extra(xy)) /
    (radial(xy) + tan(xy))."""
    px = torch.as_tensor(pixels, dtype=torch.float32)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=px.device)
    f, c, k, p = _consts(camera, px)
    target = (px - c) / f  # distorted normalized coords
    xy = target
    for _ in range(iters):
        r2 = xy.square().sum(dim=-1, keepdim=True)
        radial = 1.0 + k[0] * r2 + k[1] * r2 ** 2 + k[2] * r2 ** 3
        tan = p[0] * xy[..., 1:2] + p[1] * xy[..., 0:1]
        extra = torch.cat([p[1] * r2, p[0] * r2], dim=-1)
        xy = (target - extra) / (radial + tan)
    return torch.cat([xy * depth[..., None], depth[..., None]], dim=-1)
