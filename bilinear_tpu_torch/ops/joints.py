"""MPII and H36M joint conventions (the port's numpy copy of the part of
``bilinear_tpu/ops/joints.py`` the detectors' training, fine-tuning,
evaluation and the SH conversion need)."""
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

# 16 MPII-ordered channels -> 17 H36M-ordered joints ('SH preprocess.ipynb'
# cell 7; thorax is duplicated into H36M slots 9 and 10, one of which the
# lifting pipeline later deletes as 'nose').
FROM_MPII_TO_H36M = np.asarray(
    [6, 3, 4, 5, 2, 1, 0, 7, 8, 9, 9, 13, 14, 15, 12, 11, 10], np.int32
)

# 17 H36M-ordered heatmap channels -> 16 MPII-ordered channels
# (train_hourglass_FT.py:65).
FROM_H36M_TO_MPII = np.asarray(
    [6, 5, 4, 1, 2, 3, 0, 7, 8, 9, 15, 14, 13, 10, 11, 12], np.int32
)

# 16 MPII-ordered detections -> the 16-joint H36M lifting input: the 17-way
# remap with the 'nose' slot (H36M index 9, a duplicated thorax) deleted,
# as H36M/data.py:41-43 does to the rewritten SH bins.
H36M16_FROM_MPII = np.delete(FROM_MPII_TO_H36M, 9)

# PCKh reports 14 joints, pelvis and spine dropped, in the order
# [0:6] + [10:16] + [8:10] (valid_hourglass.py:119-128,136).
PCKH_REORDER = np.asarray(
    list(range(0, 6)) + list(range(10, 16)) + [8, 9], np.int32
)

PCKH_KEYPOINTS = (
    MPII_KEYPOINTS[0:6] + MPII_KEYPOINTS[10:16] + MPII_KEYPOINTS[8:10]
)
