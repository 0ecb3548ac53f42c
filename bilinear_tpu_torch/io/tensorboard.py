"""TensorBoard scalars and images under ``{log_dir}/visualize`` (the port's
copy of ``bilinear_tpu/io/tensorboard.py``): written with tensorboardX when
it is installed, a no-op otherwise."""
from __future__ import annotations

import os

import numpy as np

try:
    from tensorboardX import SummaryWriter as _SummaryWriter
except ImportError:  # pragma: no cover
    _SummaryWriter = None


class TBWriter:
    def __init__(self, log_dir: str, enabled: bool = True):
        """``enabled=False`` writes nothing (a data-parallel run's ranks
        but the first)."""
        self.path = os.path.join(log_dir, "visualize")
        self._w = _SummaryWriter(log_dir=self.path) \
            if _SummaryWriter and enabled else None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._w:
            self._w.add_scalar(tag, float(value), int(step))

    def image(self, tag: str, img_chw: np.ndarray, step: int) -> None:
        """img: (C, H, W) or (N, C, H, W) float in [0, 1]."""
        if self._w:
            img = np.asarray(img_chw)
            if img.ndim == 4:
                self._w.add_images(tag, img, int(step))
            else:
                self._w.add_image(tag, img, int(step))

    def close(self) -> None:
        if self._w:
            self._w.close()
