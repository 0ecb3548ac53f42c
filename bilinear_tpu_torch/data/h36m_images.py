"""H36M frames as detector records (counterpart of
``bilinear_tpu/data/h36m_images.py``; the reference's H36M/data.py:117-162,
its position_only=False branch), for the hourglass fine-tuning, its
evaluation and the SH conversion.

``H36MImageRecords`` gives ``MPIIHostPipeline`` one record per frame of an
``H36MSplit``: the image at ``{data_dir}/{subject}/{image_name}``, the
un-normalised 16-joint 2D parts (nose already dropped at load) as
keypoints, every joint valid, head 1.0 (H36M has no head rectangle).
"""
from __future__ import annotations

import os

import numpy as np

from bilinear_tpu_torch.data.h36m import H36MSplit, decode_image_name
from bilinear_tpu_torch.data.mpii import NUM_JOINTS, MPIIRecord


class H36MImageRecords:
    """Duck-typed like ``MPIIAnnotations`` for ``MPIIHostPipeline``:
    ``__len__``, ``record(i)``, ``image_path(rec)``."""

    def __init__(self, split: H36MSplit, data_dir: str):
        self.split = split
        self.data_dir = data_dir

    def __len__(self) -> int:
        return len(self.split)

    def record(self, index: int) -> MPIIRecord:
        keypoints = self.split.raw_part[index].reshape(NUM_JOINTS, 2)
        return MPIIRecord(
            image_name=self.split.images[index],
            center=self.split.centers[index].astype(np.float32),
            scale=float(self.split.scales[index]),
            head=1.0,
            keypoints=keypoints.astype(np.float32),
            valid=np.ones(NUM_JOINTS, bool),
            img_idx=index,
            r_idx=0,
        )

    def image_path(self, record: MPIIRecord) -> str:
        subject = decode_image_name(record.image_name)[0]
        return os.path.join(self.data_dir, subject, record.image_name)
