"""Synthetic, schema-exact H36M annotation bins for tests and the chip smoke
run (the port's own copy of ``make_h36m_bin`` and ``write_h36m_dataset``
from ``bilinear_tpu/data/synthetic.py``; same seeds give the same arrays).

- 'image': ``{subject}_{action}.{camera}_{frame}.jpg`` names
- 'S':      (N, 17, 3) float camera-space mm
- 'part':   (N, 17, 2) float pixel keypoints
- 'center': list of (2,) arrays
- 'scale':  float, person bbox = 200*scale px
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

ACTIONS = ["Directions", "Eating", "Posing", "Walking", "Walking_1"]
CAMERAS = ["54138969", "55011271", "58860488", "60457274"]


def make_h36m_bin(
    n: int,
    seed: int = 0,
    subjects: Optional[List[str]] = None,
    img_size: int = 256,
) -> Dict[str, list]:
    """A plausible random H36M annotation dict: 3D skeletons around camera
    space z~5000 mm, 2D parts placed inside an img_size^2 frame."""
    rng = np.random.RandomState(seed)
    subjects = subjects or ["S1", "S5"]

    s = rng.randn(n, 17, 3).astype(np.float32) * 200.0
    s[:, :, 2] += 5000.0
    # Pelvis anchors the skeleton near the body center.
    s[:, 0, :] = s.mean(axis=1)

    centers = [
        np.asarray(
            [img_size / 2 + rng.uniform(-20, 20), img_size / 2 + rng.uniform(-20, 20)],
            np.float32,
        )
        for _ in range(n)
    ]
    scales = [float(rng.uniform(0.5, 0.8)) for _ in range(n)]  # box 100-160 px
    part = np.stack(
        [
            centers[i]
            + (s[i, :, :2] - s[i, :, :2].mean(0)) * (100.0 * scales[i] / 700.0)
            for i in range(n)
        ]
    ).astype(np.float32)

    images = []
    for i in range(n):
        subject = subjects[i % len(subjects)]
        action = ACTIONS[i % len(ACTIONS)]
        camera = CAMERAS[i % len(CAMERAS)]
        images.append(f"{subject}_{action}.{camera}_{i:06d}.jpg")

    return {
        "image": images,
        "S": [s[i] for i in range(n)],
        "part": [part[i] for i in range(n)],
        "center": centers,
        "scale": scales,
    }


def write_h36m_dataset(
    data_dir: str,
    n_train: int = 128,
    n_valid: int = 64,
    protocol: str = "GT",
    seed: int = 0,
    img_size: int = 256,
) -> str:
    """Write ``{train,valid}_{protocol}.bin`` into ``data_dir`` (annotation
    bins only; the image trees of the detector paths come with that slice)."""
    os.makedirs(data_dir, exist_ok=True)
    for task, n, s in [("train", n_train, seed), ("valid", n_valid, seed + 1)]:
        data = make_h36m_bin(n, seed=s, img_size=img_size)
        with open(os.path.join(data_dir, f"{task}_{protocol}.bin"), "wb") as f:
            pickle.dump(data, f)
    return data_dir
