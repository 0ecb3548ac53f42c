"""GT -> SH conversion (counterpart of ``bilinear_tpu/data/sh_convert.py``;
the working replacement for the reference's 'SH preprocess.ipynb'): run a
trained detector over the H36M train and valid frames and rewrite the 2D
``part`` annotations with its detections.

Per frame: the un-augmented crop through an eval-mode forward on the
model's device, the argmax of the last stack's heatmaps, mapped to
original-image pixels with the record's own centre and scale
(``eval/mpii_test_export.py``); the 16 MPII-ordered joints remapped into 17
H36M-ordered ones with ``FROM_MPII_TO_H36M`` (thorax duplicated into slots
9 and 10, one later deleted as 'nose' by the lifting loader). Each
``{task}_GT.bin`` is copied to ``{task}_{protocol_out}.bin`` with only
``part`` rewritten; ``train_bilinear --protocol SH`` (or SH+FT) then lifts
from the detections. A torch7 detector built with ``fused=True`` runs every
ResModule of these forwards through kernel K3 (eval mode).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from bilinear_tpu_torch.data.h36m import Annotation, load_h36m, tasks
from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
from bilinear_tpu_torch.eval.mpii_test_export import _to_original_space, \
    export_heatmap_poses
from bilinear_tpu_torch.ops.joints import FROM_MPII_TO_H36M
from bilinear_tpu_torch.train.hourglass import batch_tensors


@torch.no_grad()
def convert_gt_to_sh(model: torch.nn.Module, data_dir: str,
                     protocol_out: str = "SH", batch_size: int = 16,
                     canvas: int = 512, transport: str = "u8"
                     ) -> Dict[str, str]:
    """Write ``{task}_{protocol_out}.bin`` for both splits; returns {task:
    path}. The model's train/eval mode is restored afterwards."""
    splits = load_h36m(data_dir, "GT")
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    written = {}
    try:
        for task in tasks:
            split = splits[task]
            records = H36MImageRecords(split, data_dir)
            pipeline = MPIIHostPipeline(records, batch_size, canvas=canvas,
                                        pad=True, transport=transport)
            detections = np.zeros((len(split), 16, 2), np.float32)
            for batch in pipeline.epoch(0):
                pose_hm = export_heatmap_poses(
                    model, batch_tensors(batch, dev)).cpu().numpy()
                poses = _to_original_space(pose_hm, records, batch.index)
                real = batch.index >= 0
                detections[batch.index[real]] = poses[real]

            part17 = detections[:, FROM_MPII_TO_H36M, :]
            with open(os.path.join(data_dir, f"{task}_GT.bin"), "rb") as f:
                raw = pickle.load(f)
            raw[Annotation.Part] = [part17[i] for i in range(len(split))]
            out_path = os.path.join(data_dir, f"{task}_{protocol_out}.bin")
            with open(out_path, "wb") as f:
                pickle.dump(raw, f, protocol=pickle.HIGHEST_PROTOCOL)
            written[task] = out_path
    finally:
        model.train(was_training)
    return written
