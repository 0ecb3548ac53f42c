"""MPII joint conventions (the port's numpy copy of the part of
``bilinear_tpu/ops/joints.py`` the detector's training needs)."""
from __future__ import annotations

import numpy as np

# Horizontal-flip left/right swap in MPII order (MPII/data.py:113 of the
# reference).
MPII_FLIP_SWAP = np.asarray(
    [5, 4, 3, 2, 1, 0, 6, 7, 8, 9, 15, 14, 13, 12, 11, 10], np.int32
)
