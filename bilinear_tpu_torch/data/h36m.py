"""Human3.6M annotation-bin reader, statistics and normalization (the
port's own numpy-only copy of ``bilinear_tpu/data/h36m.py``).

- loads BOTH ``{data_dir}/{train,valid}_{protocol}.bin`` pickles (valid-time
  normalization needs the train-split statistics);
- 2D ``part``: drop joint 9 (nose) -> (N, 16, 2) -> (N, 32);
- 3D ``S``: root-center by the pelvis (joint 0), drop it -> (N, 48);
- per-dimension mean/std (ddof=0) of the TRAIN split z-score both splits.

The bins are pickles: load only files this project or its users wrote.
"""
from __future__ import annotations

import os
import pickle
import sys
import types
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


class Task:
    """String-enum split names (H36M/task.py:1-9)."""

    Train = "train"
    Valid = "valid"


tasks = [Task.Train, Task.Valid]


class Protocol:
    """2D-keypoint source (H36M/protocol.py:1-4)."""

    GT = "GT"  # ground-truth projections
    SH = "SH"  # stacked-hourglass detections
    SH_FT = "SH+FT"  # fine-tuned stacked-hourglass detections


class Annotation:
    """Annotation-dict keys (H36M/annotation.py:1-9)."""

    S = "S"
    Center = "center"
    Part = "part"
    Scale = "scale"
    Image = "image"
    Root_Of = "root of "
    Mean_Of = "mean of "
    Stddev_Of = "stddev of "


# H36M 17-joint indexing facts baked into the reference pipeline
# (H36M/data.py:41-54, model/bilinear.py:20).
PELVIS = 0
NOSE = 9
NUM_JOINTS_17 = 17
NUM_JOINTS = 16


def _install_vectormath_shim() -> None:
    """Real reference bins pickle ``vectormath.Vector2`` objects for centers
    (SURVEY.md §8). vectormath is not installed here; provide a minimal
    ndarray-subclass shim so those pickles load into plain arrays."""
    if "vectormath" in sys.modules:
        return

    class Vector2(np.ndarray):
        def __new__(cls, *args):
            if len(args) == 1:
                arr = np.asarray(args[0], dtype=np.float64)
            else:
                arr = np.asarray(args, dtype=np.float64)
            return arr.view(cls)

        @property
        def x(self):
            return self[0].item()  # int after .astype(int), float otherwise

        @property
        def y(self):
            return self[1].item()

        @property
        def length(self):
            return float(np.linalg.norm(np.asarray(self, dtype=np.float64)))

    # Make the class pickle-compatible in both directions (real bins
    # reference 'vectormath.Vector2' by module path).
    Vector2.__module__ = "vectormath"
    Vector2.__qualname__ = "Vector2"

    mod = types.ModuleType("vectormath")
    mod.Vector2 = Vector2
    vec_mod = types.ModuleType("vectormath.vector")
    vec_mod.Vector2 = Vector2
    mod.vector = vec_mod
    sys.modules["vectormath"] = mod
    sys.modules["vectormath.vector"] = vec_mod


def decode_image_name(image_name: str):
    """Parse ``{subject}_{action}.{camera}_{frame}.jpg`` (H36M/util.py:13-22);
    actions may contain one underscore (sub-action suffix)."""
    subject_action, camera_frame, _ = image_name.split(".")
    split = subject_action.split("_")
    subject = split[0]
    action = split[1]
    if len(split) >= 3:
        action = action + "_" + split[2]
    camera, frame = camera_frame.split("_")
    return subject, action, camera, frame


def strip_subaction(action: str) -> str:
    """MPJPE accumulation merges sub-actions: 'Walking_1' -> 'Walking'
    (valid_bilinear.py:63-64)."""
    return action.split("_")[0]


@dataclass
class H36MSplit:
    """One split, fully preprocessed and ready for device residence."""

    part: np.ndarray  # (N, 32) float32 — normalized 2D input
    s: np.ndarray  # (N, 48) float32 — normalized root-centered 3D target
    raw_part: np.ndarray  # (N, 32) un-normalized
    raw_s: np.ndarray  # (N, 48) un-normalized (root-centered mm)
    mean_part: np.ndarray  # (32,) train-split stats used for normalization
    std_part: np.ndarray
    mean_s: np.ndarray  # (48,)
    std_s: np.ndarray
    images: List[str]
    actions: np.ndarray  # (N,) int32 action ids
    action_names: List[str]  # id -> merged action name
    centers: np.ndarray  # (N, 2) float32
    scales: np.ndarray  # (N,) float32

    def __len__(self) -> int:
        return self.part.shape[0]


def _preprocess_part(part17: np.ndarray) -> np.ndarray:
    """(N,17,2) -> (N,32): drop nose, flatten (H36M/data.py:41-43,57)."""
    part16 = np.delete(part17.astype(np.float32), NOSE, axis=1)
    return part16.reshape(-1, 2 * NUM_JOINTS)


def _preprocess_s(s17: np.ndarray) -> np.ndarray:
    """(N,17,3) -> (N,48): root-center by pelvis, drop pelvis, flatten
    (H36M/data.py:46-54,57)."""
    s17 = s17.astype(np.float32)
    centered = s17 - s17[:, PELVIS : PELVIS + 1, :]
    return centered[:, 1:, :].reshape(-1, 3 * NUM_JOINTS)


def load_h36m(
    data_dir: str,
    protocol: str = Protocol.GT,
) -> Dict[str, H36MSplit]:
    """Load and preprocess both splits. Returns {task: H36MSplit}, with both
    splits normalized by the TRAIN-split statistics (H36M/data.py:87-110)."""
    if protocol not in (Protocol.GT, Protocol.SH, Protocol.SH_FT):
        raise ValueError(f"unknown protocol {protocol!r}")
    _install_vectormath_shim()

    raw: Dict[str, dict] = {}
    for task in tasks:
        path = os.path.join(data_dir, f"{task}_{protocol}.bin")
        with open(path, "rb") as f:
            raw[task] = pickle.load(f)

    prepped = {}
    for task in tasks:
        d = raw[task]
        part = _preprocess_part(np.asarray(d[Annotation.Part], dtype=np.float32))
        s = _preprocess_s(np.asarray(d[Annotation.S], dtype=np.float32))
        centers = np.asarray(
            [np.asarray(c, dtype=np.float32)[:2] for c in d[Annotation.Center]],
            dtype=np.float32,
        )
        scales = np.asarray(d[Annotation.Scale], dtype=np.float32).reshape(-1)
        prepped[task] = dict(
            part=part, s=s, images=list(d[Annotation.Image]),
            centers=centers, scales=scales,
        )

    # Statistics come from each split, but NORMALIZATION always uses train's
    # (the reference computes both, then indexes Task.Train: H36M/data.py:87-94).
    train = prepped[Task.Train]
    mean_part = train["part"].mean(axis=0)
    std_part = train["part"].std(axis=0)
    mean_s = train["s"].mean(axis=0)
    std_s = train["s"].std(axis=0)

    out: Dict[str, H36MSplit] = {}
    for task in tasks:
        p = prepped[task]
        actions = [strip_subaction(decode_image_name(n)[1]) for n in p["images"]]
        names = sorted(set(actions))
        name_to_id = {n: i for i, n in enumerate(names)}
        action_ids = np.asarray([name_to_id[a] for a in actions], dtype=np.int32)
        out[task] = H36MSplit(
            part=(p["part"] - mean_part) / std_part,
            s=(p["s"] - mean_s) / std_s,
            raw_part=p["part"],
            raw_s=p["s"],
            mean_part=mean_part,
            std_part=std_part,
            mean_s=mean_s,
            std_s=std_s,
            images=p["images"],
            actions=action_ids,
            action_names=names,
            centers=p["centers"],
            scales=p["scales"],
        )
    return out
