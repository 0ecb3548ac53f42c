"""MPII annotation parsing, the persisted train/valid split and the official
test rects (the port's copy of ``MPIIAnnotations`` and
``MPIITestAnnotations`` from ``bilinear_tpu/data/mpii.py``).

- parses the official ``mpii_human_pose_v1_u12_1.mat`` with
  ``scipy.io.loadmat(squeeze_me=True, struct_as_record=False)``;
- generates or loads a shuffled 90/10 train/valid split over (img_idx,
  r_idx) person rects whose objpos annotation is intact, persisted to
  ``{root}/MPII-{train,valid}.txt``;
- per record: scale = 1.25 * anno.scale, center = objpos + (0, 15 *
  anno.scale), PCKh head size = 0.6 * ||head-rect diagonal||, keypoints
  NaN where unannotated with a validity mask.

Image decoding happens in ``data/pipeline.py``; this module is annotation
bookkeeping only.
"""
from __future__ import annotations

import math
import os
import random as py_random
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import scipy.io

NUM_JOINTS = 16


@dataclass
class MPIIRecord:
    image_name: str
    center: np.ndarray  # (2,) float32, includes the +15*scale y shift
    scale: float  # includes the 1.25 factor
    head: float  # PCKh reference length
    keypoints: np.ndarray  # (16, 2) float32, NaN where unannotated
    valid: np.ndarray  # (16,) bool
    img_idx: int  # 0-based into annolist
    r_idx: int  # 0-based into annorect


def _as_list(x):
    return list(x) if isinstance(x, np.ndarray) else [x]


class MPIIAnnotations:
    """Parsed .mat + split files. ``task`` selects the persisted subset."""

    def __init__(self, root: str, task: str, mat_name: str = "mpii_human_pose_v1_u12_2/mpii_human_pose_v1_u12_1.mat",
                 split_seed: Optional[int] = None):
        self.root = root
        self.task = task
        self.image_dir = os.path.join(root, "images")

        mat_path = os.path.join(root, mat_name)
        release = scipy.io.loadmat(
            mat_path, squeeze_me=True, struct_as_record=False
        )["RELEASE"]
        self.annolist = _as_list(release.annolist)
        self.img_train = np.atleast_1d(np.asarray(release.img_train))
        self.single_person = getattr(release, "single_person", None)

        subset_path = os.path.join(root, f"MPII-{task}.txt")
        if not os.path.exists(subset_path):
            self.refresh_subset(seed=split_seed)
        # reshape(-1, 2), not atleast_2d: an EMPTY split file must yield 0
        # records, not one phantom (1, 0) row (pinned by test_schema_fuzz).
        self.subset = np.loadtxt(subset_path, dtype=np.int32).reshape(-1, 2)

    # ------------------------------------------------------------- split
    def refresh_subset(self, train_fraction: float = 0.9, seed: Optional[int] = None):
        """Shuffled 90/10 split over rects with intact objpos
        (MPII/data.py:37-68)."""
        correct: List[Tuple[int, int]] = []
        for img_idx in np.nonzero(self.img_train != 0)[0]:
            annorect = _as_list(self.annolist[img_idx].annorect)
            for r_idx, rect in enumerate(annorect):
                try:
                    assert rect.objpos.y  # annotation-intact probe
                    correct.append((int(img_idx), int(r_idx)))
                except Exception:
                    continue
        rng = py_random.Random(seed)
        rng.shuffle(correct)
        arr = np.asarray(correct, dtype=np.int64).reshape(-1, 2)
        n_train = int(train_fraction * len(arr))
        np.savetxt(os.path.join(self.root, "MPII-train.txt"), arr[:n_train], fmt="%u")
        np.savetxt(os.path.join(self.root, "MPII-valid.txt"), arr[n_train:], fmt="%u")

    # ------------------------------------------------------------ records
    def __len__(self) -> int:
        return len(self.subset)

    def record(self, index: int) -> MPIIRecord:
        img_idx, r_idx = (int(v) for v in self.subset[index])
        anno = self.annolist[img_idx]
        rect = _as_list(anno.annorect)[r_idx]

        raw_scale = float(rect.scale)
        center = np.asarray(
            [float(rect.objpos.x), float(rect.objpos.y) + 15.0 * raw_scale],
            np.float32,
        )
        scale = 1.25 * raw_scale
        head = 0.6 * math.sqrt(
            (float(rect.x2) - float(rect.x1)) ** 2
            + (float(rect.y2) - float(rect.y1)) ** 2
        )

        keypoints = np.full((NUM_JOINTS, 2), np.nan, np.float32)
        valid = np.zeros(NUM_JOINTS, bool)
        points = getattr(getattr(rect, "annopoints", None), "point", None)
        if points is None:
            # The split probe only checks objpos (refresh_subset, matching
            # MPII/data.py:52-57), so a train-split rect can reach here with
            # no keypoints at all. The reference crashes on such a rect
            # (MPII/data.py:104 AttributeError); an all-invalid record would
            # silently train on an all-zero heatmap target instead. Reject
            # loudly — pinned by tests/test_schema_fuzz.py.
            raise ValueError(
                f"MPII rect (img {img_idx}, rect {r_idx}) is in the split "
                "(objpos intact) but has no annopoints; regenerate the "
                "split or fix the annotation"
            )
        for kp in _as_list(points):
            j = int(kp.id)
            keypoints[j] = [float(kp.x), float(kp.y)]
            valid[j] = True

        return MPIIRecord(
            image_name=str(anno.image.name),
            center=center,
            scale=scale,
            head=head,
            keypoints=keypoints,
            valid=valid,
            img_idx=img_idx,
            r_idx=r_idx,
        )

    def image_path(self, record: MPIIRecord) -> str:
        return os.path.join(self.image_dir, record.image_name)


class MPIITestAnnotations:
    """The official MPII test-set rects for prediction export, with the
    reference's conventions (``eval_hourglass.py:62-126``):

    - ``img_idx`` / ``r_idx`` are 1-based and relative to the subset
      (annolist filtered to ``img_train == 0``; ``== 1`` with
      ``train_subset``), as the exporter and ``eval_converter.m`` walk it;
    - only rects listed in ``single_person`` with an intact objpos;
    - center = the raw objpos (no +15 * scale shift, unlike training),
      scale = 1.25 * the raw scale.

    Duck-typed for ``MPIIHostPipeline`` (``__len__``, ``record``,
    ``image_path``)."""

    def __init__(self, root: str, train_subset: bool = False,
                 mat_name: str = "mpii_human_pose_v1_u12_2/mpii_human_pose_v1_u12_1.mat"):
        self.root = root
        self.image_dir = os.path.join(root, "images")
        release = scipy.io.loadmat(
            os.path.join(root, mat_name), squeeze_me=True,
            struct_as_record=False)["RELEASE"]
        annolist = _as_list(release.annolist)
        img_train = np.atleast_1d(np.asarray(release.img_train))
        singles = _as_list(release.single_person)

        want = 1 if train_subset else 0
        self.entries: List[MPIIRecord] = []
        subset_img_idx = 0
        for img_idx in range(len(annolist)):
            if img_train[img_idx] != want:
                continue
            subset_img_idx += 1
            rects = _as_list(annolist[img_idx].annorect)
            sp = np.atleast_1d(np.asarray(singles[img_idx])).reshape(-1)
            for r_idx, rect in enumerate(rects):
                try:
                    if (r_idx + 1) not in sp:
                        continue
                    center = np.asarray(
                        [float(rect.objpos.x), float(rect.objpos.y)],
                        np.float32)
                    scale = 1.25 * float(rect.scale)
                except Exception:
                    continue
                self.entries.append(MPIIRecord(
                    image_name=str(annolist[img_idx].image.name),
                    center=center,
                    scale=scale,
                    head=1.0,
                    keypoints=np.full((NUM_JOINTS, 2), np.nan, np.float32),
                    valid=np.zeros(NUM_JOINTS, bool),
                    img_idx=subset_img_idx,  # 1-based, subset-relative
                    r_idx=r_idx + 1,  # 1-based
                ))

    def __len__(self) -> int:
        return len(self.entries)

    def record(self, index: int) -> MPIIRecord:
        return self.entries[index]

    def image_path(self, record: MPIIRecord) -> str:
        return os.path.join(self.image_dir, record.image_name)
