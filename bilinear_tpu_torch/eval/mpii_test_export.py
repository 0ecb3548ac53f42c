"""The official MPII test-set prediction export and the MATLAB toolkit's
converter (counterpart of ``bilinear_tpu/eval/mpii_test_export.py``):

- ``export_predictions`` (eval_hourglass.py:128-161 of the reference): one
  ``{img_idx}.{r_idx}.txt`` per test rect with 16 ``joint x y`` lines, from
  the argmax of the last stack's heatmaps of an eval-mode forward on the
  model's device. Poses go to original-image pixels with each record's own
  centre and scale: the pipeline's batch centres and scales are canvas
  space, the toolkit wants the original frame, and the crop the network
  sees is the same either way.
- ``convert_predictions`` (eval_converter.m:1-48): the test annolist with
  the predicted annopoints injected, saved as ``pred_keypoints_mpii.mat``
  for the official evaluation kit, through scipy.io (no MATLAB).
"""
from __future__ import annotations

import os

import numpy as np
import scipy.io
import torch

from bilinear_tpu_torch.data.mpii import MPIITestAnnotations, _as_list
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.ops.decode import argmax_decode, \
    heatmap_to_image_space
from bilinear_tpu_torch.train.hourglass import batch_tensors, \
    preprocess_batch


@torch.no_grad()
def export_heatmap_poses(model: torch.nn.Module, batch: dict
                         ) -> torch.Tensor:
    """Crop -> eval forward -> argmax: heatmap-space poses (B, 16, 2) of a
    batch of device tensors; the model must be in eval mode."""
    crops, _, _ = preprocess_batch(
        batch["images"], batch["centers"], batch["scales"],
        batch["keypoints"], batch["valid"], None)
    out = model(crops)[-1]  # (B, H, W, J)
    return argmax_decode(out.permute(0, 3, 1, 2))


def _to_original_space(pose_hm: np.ndarray, annotations,
                       index: np.ndarray) -> np.ndarray:
    """Heatmap-space poses to original-image pixels with each slot's own
    record centre and scale (padded slots pass through)."""
    centers = np.zeros((pose_hm.shape[0], 2), np.float32)
    scales = np.ones((pose_hm.shape[0],), np.float32)
    for slot in range(pose_hm.shape[0]):
        if index[slot] >= 0:
            rec = annotations.record(int(index[slot]))
            centers[slot] = rec.center
            scales[slot] = rec.scale
    return heatmap_to_image_space(torch.from_numpy(pose_hm),
                                  torch.from_numpy(centers),
                                  torch.from_numpy(scales)).numpy()


@torch.no_grad()
def export_predictions(model: torch.nn.Module,
                       annotations: MPIITestAnnotations,
                       prediction_dir: str, batch_size: int = 8,
                       canvas: int = 512) -> int:
    """Write one txt per test rect; returns the number of rects exported.
    The model's train/eval mode is restored afterwards."""
    os.makedirs(prediction_dir, exist_ok=True)
    pipeline = MPIIHostPipeline(annotations, batch_size, canvas=canvas,
                                pad=True)
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    exported = 0
    try:
        for batch in pipeline.epoch(0):
            pose_hm = export_heatmap_poses(
                model, batch_tensors(batch, dev)).cpu().numpy()
            poses = _to_original_space(pose_hm, annotations, batch.index)
            for slot in range(batch.images.shape[0]):
                if batch.index[slot] < 0:
                    continue
                rec = annotations.record(int(batch.index[slot]))
                path = os.path.join(prediction_dir,
                                    f"{rec.img_idx}.{rec.r_idx}.txt")
                with open(path, "w") as f:
                    for joint in range(16):
                        f.write(f"{joint} {poses[slot, joint, 0]} "
                                f"{poses[slot, joint, 1]}\n")
                exported += 1
    finally:
        model.train(was_training)
    return exported


def convert_predictions(
    root: str, prediction_dir: str, out_path: str,
    mat_name: str = "mpii_human_pose_v1_u12_2/mpii_human_pose_v1_u12_1.mat",
) -> int:
    """eval_converter.m in Python: build ``pred`` (the test annolist with
    the predicted annopoints injected) and save it as a .mat the official
    MPII evaluation kit reads. Returns the number of rects injected."""
    release = scipy.io.loadmat(
        os.path.join(root, mat_name), squeeze_me=True,
        struct_as_record=False)["RELEASE"]
    annolist = _as_list(release.annolist)
    img_train = np.atleast_1d(np.asarray(release.img_train))
    singles = _as_list(release.single_person)

    pred = []
    n = 0
    subset_img_idx = 0
    for img_idx in range(len(annolist)):
        if img_train[img_idx] != 0:
            continue
        subset_img_idx += 1
        rects_out = []
        rects = _as_list(annolist[img_idx].annorect)
        sp = np.atleast_1d(np.asarray(singles[img_idx])).reshape(-1)
        for r_idx, rect in enumerate(rects):
            # Rects outside single_person in the real release often carry
            # empty scale fields (0-size arrays under squeeze_me): anything
            # non-scalar counts as absent.
            s = getattr(rect, "scale", None)
            entry = {"scale": float(s) if np.ndim(s) == 0 and s is not None
                     else 0.0}
            objpos = getattr(rect, "objpos", None)
            if objpos is not None:
                try:
                    entry["objpos"] = {"x": float(objpos.x),
                                       "y": float(objpos.y)}
                except Exception:
                    objpos = None
            txt = os.path.join(prediction_dir,
                               f"{subset_img_idx}.{r_idx + 1}.txt")
            if objpos is not None and (r_idx + 1) in sp and \
                    os.path.exists(txt):
                m = np.loadtxt(txt)
                points = [{"id": int(m[j, 0]), "x": float(m[j, 1]),
                           "y": float(m[j, 2])} for j in range(16)]
                entry["annopoints"] = {"point": np.asarray(points,
                                                           dtype=object)}
                n += 1
            rects_out.append(entry)
        pred.append({"image": {"name": str(annolist[img_idx].image.name)},
                     "annorect": np.asarray(rects_out, dtype=object)})

    scipy.io.savemat(out_path, {"pred": np.asarray(pred, dtype=object)},
                     long_field_names=True)
    return n
