"""MPII joint conventions (the port's numpy copy of the part of
``bilinear_tpu/ops/joints.py`` the detector's training and evaluation
need)."""
from __future__ import annotations

import numpy as np

# Canonical MPII 16-joint order (MPII/keypoint.py:1-37 of the reference).
MPII_KEYPOINTS = [
    "R ankle", "R knee", "R hip", "L hip", "L knee", "L ankle", "Pelvis",
    "Spine", "Thorax", "Head", "R wrist", "R elbow", "R shoulder",
    "L shoulder", "L elbow", "L wrist",
]

# Horizontal-flip left/right swap in MPII order (MPII/data.py:113 of the
# reference).
MPII_FLIP_SWAP = np.asarray(
    [5, 4, 3, 2, 1, 0, 6, 7, 8, 9, 15, 14, 13, 12, 11, 10], np.int32
)

# PCKh reports 14 joints, pelvis and spine dropped, in the order
# [0:6] + [10:16] + [8:10] (valid_hourglass.py:119-128,136).
PCKH_REORDER = np.asarray(
    list(range(0, 6)) + list(range(10, 16)) + [8, 9], np.int32
)

PCKH_KEYPOINTS = (
    MPII_KEYPOINTS[0:6] + MPII_KEYPOINTS[10:16] + MPII_KEYPOINTS[8:10]
)
