"""What the End2End cells share: the served system built from the seeded
weights, and the comparison of served answers with the reference."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model as ref
from portbench.reference.weights import end2end_weights

BLOCK = 16  # frames per reference forward


def build(run):
    """The seeded weights on the card (kept for the reference), and
    ``End2EndServer`` on their ``.save`` tree: bf16 with the fused torch7
    detector (K3), at the cell's batch sizes; the control serves the same
    weights through the port's int8 detector (K6/K7)."""
    from bilinear_tpu_torch.serving import End2EndServer

    cfg, wl = run.config, run.workload
    w, stats = end2end_weights(cfg, run.seed, run.device)
    run.state["weights"], run.state["stats"] = w, stats

    def host(t):
        return t.detach().cpu().numpy()

    return End2EndServer(
        w.tree(), host(stats.mean_part), host(stats.std_part),
        host(stats.mean_s), host(stats.std_s), variant=cfg["variant"],
        dtype=getattr(torch, wl["dtype"]), batch_sizes=wl["batch_sizes"],
        model_kw={"fused": True, "n_stacks": cfg["nStack"],
                  "features": cfg["nFeats"], "depth": cfg["depth"]},
        quantize="int8" if run.control else None, device=run.device)


def numbers(run, frames: np.ndarray, pose2d: np.ndarray,
            pose3d: np.ndarray) -> dict:
    """The served answers of ``frames`` against the reference in f32.

    2D (the detector, K3, soft-argmax and decode, chunking and padding,
    u8 -> f32, and for HTTP the batcher's scatter): the 75th percentile of
    |served - reference| over every coordinate, in units of the same
    percentile for the reference itself run in the served precision. With
    random weights, bf16 rounding alone moves the soft-argmax by 1.2-2 px
    at that percentile, by a factor that differs from seed to seed; the
    ratio takes that factor out, so a sound bf16 program reads ~1 on every
    seed. 3D: the served 3D pose against the reference's lifter run on the
    served 2D pose, in mm (the joint reorder, z-scoring, the lifter and
    un-normalisation, apart from the detector's error, which the 2D number
    holds). For the control the 3D side is the reference's lifter with fp8
    operands in the program's place."""
    w, stats = run.state["weights"], run.state["stats"]
    cfg = run.config
    r2, h2, l3 = [], [], []
    with torch.no_grad():
        for i in range(0, len(frames), BLOCK):
            f = torch.as_tensor(frames[i:i + BLOCK], device=run.device)
            p2, _ = ref.end2end(w.net, cfg, stats, f)
            r2.append(p2.cpu().numpy())
            w.net.dtype = getattr(torch, run.workload["dtype"])
            p2, _ = ref.end2end(w.net, cfg, stats, f)
            w.net.dtype = None
            h2.append(p2.cpu().numpy())
            served = torch.as_tensor(np.asarray(pose2d[i:i + BLOCK],
                                                np.float32),
                                     device=run.device)
            l3.append(lift_of(w.net, stats, served).cpu().numpy())
            if run.control:
                w.net.fp8 = True
                pose3d[i:i + BLOCK] = lift_of(w.net, stats,
                                              served).cpu().numpy()
                w.net.fp8 = False
    r2, h2, l3 = np.concatenate(r2), np.concatenate(h2), np.concatenate(l3)
    g2 = np.abs(np.asarray(pose2d, np.float64) - r2).ravel()
    own = np.percentile(np.abs(h2.astype(np.float64) - r2), 75)
    g3 = np.abs(np.asarray(pose3d, np.float64) - l3).ravel()
    p75 = float(np.percentile(g2, 75))
    return {
        "pose2d_p75_vs_ref_bf16": p75 / float(own),
        "pose2d_p75_px": p75, "ref_bf16_pose2d_p75_px": float(own),
        "pose2d_max_px": float(g2.max()),
        "pose3d_p75_mm": float(np.percentile(g3, 75)),
        "pose3d_max_mm": float(g3.max()),
        "ref_pose2d_spread_px": float(r2.std(axis=0).mean()),
        "ref_pose3d_spread_mm": float(l3.std(axis=0).mean()),
        "frames_compared": float(len(frames)),
    }


def lift_of(net, stats, pose2d: torch.Tensor) -> torch.Tensor:
    """The reference's lifter on 2D poses in MPII order, in mm."""
    x = (ref.mpii_to_lifter(pose2d) - stats.mean_part) / stats.std_part
    out = net.lifter(x, ("bilinear",))
    return (out * stats.std_s + stats.mean_s).reshape(-1, 16, 3)
