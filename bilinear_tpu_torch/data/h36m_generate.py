"""GT annotation-bin generation from 3D ground truth and camera calibration
(counterpart of ``bilinear_tpu/data/h36m_generate.py``).

The reference reads ``{train,valid}_GT.bin`` pickles built elsewhere and
ships only the camera intrinsics that built them. This is that producer:
camera-space 3D joints go through the full distortion model
(``data/camera.py::project_np``) to the 2D 'part' annotations, the person
centre and scale come from the projected bounding box, and the bins follow
the schema of ``data/h36m.py`` exactly (the same bytes as the JAX
package's for the same inputs), so both packages' ``load_h36m`` read them.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from bilinear_tpu_torch.data.camera import Camera, project_np
from bilinear_tpu_torch.data.h36m import Annotation


def project_poses(s_cam: np.ndarray, camera: Camera) -> np.ndarray:
    """(N, 17, 3) camera-space mm -> (N, 17, 2) pixel keypoints (numpy: a
    host-side producer)."""
    return project_np(np.asarray(s_cam, np.float32), camera)


def bbox_center_scale(part: np.ndarray, margin: float = 1.15):
    """Person centre and scale from the projected keypoints: the centre of
    the bounding box, and the scale whose 200*scale crop box covers the
    box's longer side with ``margin``."""
    lo = part.min(axis=-2)  # (N, 2)
    hi = part.max(axis=-2)
    center = (lo + hi) / 2.0
    side = (hi - lo).max(axis=-1) * margin  # (N,)
    scale = side / 200.0
    return center.astype(np.float32), scale.astype(np.float32)


def build_gt_bin(
    s_cam: np.ndarray,  # (N, 17, 3) camera-space mm
    image_names: Sequence[str],
    camera: Camera,
) -> Dict[str, list]:
    """One schema-exact annotation dict."""
    n = s_cam.shape[0]
    assert len(image_names) == n
    part = project_poses(s_cam, camera)
    center, scale = bbox_center_scale(part)
    return {
        Annotation.Image: list(image_names),
        Annotation.S: [s_cam[i].astype(np.float32) for i in range(n)],
        Annotation.Part: [part[i].astype(np.float32) for i in range(n)],
        Annotation.Center: [center[i] for i in range(n)],
        Annotation.Scale: [float(s) for s in scale],
    }


def write_gt_bins(
    data_dir: str,
    splits: Dict[str, Dict[str, object]],
) -> List[str]:
    """splits: {task: {'S': (N,17,3), 'images': [...], 'camera': Camera}}.
    Writes ``{task}_GT.bin`` files; returns their paths."""
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for task, spec in splits.items():
        data = build_gt_bin(
            np.asarray(spec["S"], np.float32), spec["images"], spec["camera"]
        )
        path = os.path.join(data_dir, f"{task}_GT.bin")
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        paths.append(path)
    return paths
