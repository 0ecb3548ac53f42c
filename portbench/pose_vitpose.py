"""What the ViTPose End2End cell builds: the seeded weights of
``reference/vitpose_layout.py``, calibrated by the ViTPose reference, the
served system on their ``.save`` tree, and the comparison of served
answers with the reference (``pose.numbers``'s numbers).

The weights follow the rules of ``reference/weights.py`` (the
configuration's ``assumed``): four draws on the device, kernels N(0,
2/fan_in) (``pos_embed`` N(0, 0.02^2)), biases U(+-1/sqrt(fan_in)), and
LayerNorm and BN scales log-uniform over ``bn_scale_range`` and biases
normal with ``bn_bias``; the deconvolutions have no bias, as published.
The last Linear of each residual branch (a block's ``attn.proj`` and
``mlp.fc2``) has its kernel times ``residual_scale``, as a trained
residual network's branches are small against its stream (the
configuration's ``assumed`` says why this value).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench import seeds
from portbench.pose import BLOCK, lift_of
from portbench.reference import vitpose as ref
from portbench.reference import vitpose_layout
from portbench.reference.model import Stats, mpii_to_lifter, softargmax
from portbench.reference.weights import CALIBRATION_FRAMES, _put, _s_stats

BIASED = ("conv_b", "dense")
POS_STD = 0.02
RESIDUAL_ENDS = ("proj", "fc2")


def crop(frames: np.ndarray, width: int) -> np.ndarray:
    """The central ``width`` columns of (N, H, W, 3) frames, C-contiguous."""
    left = (frames.shape[2] - width) // 2
    return np.ascontiguousarray(frames[:, :, left:left + width])


def frame_pool(cfg: dict, seed: int, n: int,
               purpose: str = "frames") -> np.ndarray:
    """(n, H, W, 3) u8 frames at the configuration's ``image_size`` (W, H):
    the central W columns of ``seeds.frame_pool``'s 256 x 256 frames (every
    ``256 / H``-th row and column of them, for the tests' small crops)."""
    w, h = cfg["image_size"]
    step = seeds.FRAME[0] // h
    return crop(seeds.frame_pool(seed, n, purpose)[:, ::step, ::step], w)


class ViTPoseWeights:
    """``leaves``: ``{path: {name: tensor}}`` on one device, read by the
    reference (``net``); ``tree()`` is the program's copy."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        specs = list(vitpose_layout.model_leaves(cfg))
        gen = torch.Generator(device=device)
        gen.manual_seed(seeds.torch_seed(seed, "weights"))
        kernels = [s for s in specs if s[1] not in ("bn", "ln")]
        norms = [s for s in specs if s[1] in ("bn", "ln")]
        n_k = sum(math.prod(s[2]) for s in kernels)
        n_b = sum(s[2][-1] for s in kernels if s[1] in BIASED)
        n_c = sum(s[2][0] for s in norms)
        n_s = sum(s[2][0] for s in norms if s[1] == "bn")
        f32 = dict(device=device, dtype=torch.float32)
        self._k = torch.randn(n_k, generator=gen, **f32)
        self._b = torch.rand(n_b, generator=gen, **f32) * 2.0 - 1.0
        lo, hi = (math.log(v) for v in cfg["assumed"]["bn_scale_range"])
        self._g = torch.exp(torch.rand(n_c, generator=gen, **f32)
                            * (hi - lo) + lo)
        b_mean, b_std = cfg["assumed"]["bn_bias"]
        self._be = torch.randn(n_c, generator=gen, **f32) * b_std + b_mean
        self._m = torch.zeros(n_s, **f32)
        self._v = torch.ones(n_s, **f32)
        self.leaves: Dict[tuple, Dict[str, torch.Tensor]] = {}
        ok = ob = oc = os_ = 0
        for path, kind, shape in specs:
            if kind in ("bn", "ln"):
                c = shape[0]
                leaf = {"scale": self._g[oc:oc + c],
                        "bias": self._be[oc:oc + c]}
                oc += c
                if kind == "bn":
                    leaf.update(mean=self._m[os_:os_ + c],
                                var=self._v[os_:os_ + c])
                    os_ += c
                self.leaves[path] = leaf
                continue
            n = math.prod(shape)
            value = self._k[ok:ok + n].view(shape)
            ok += n
            if kind == "pos":
                value.mul_(POS_STD)
                self.leaves[path] = {"value": value}
                continue
            fan_in = math.prod(shape[:-1])
            value.mul_(math.sqrt(2.0 / fan_in))
            if path[-1] in RESIDUAL_ENDS and "blocks" in path:
                value.mul_(cfg["assumed"]["residual_scale"])
            self.leaves[path] = {"kernel": value}
            if kind in BIASED:
                bias = self._b[ob:ob + shape[-1]]
                bias.mul_(1.0 / math.sqrt(fan_in))
                self.leaves[path]["bias"] = bias
                ob += shape[-1]
        self.net = ref.ViTPose(self.leaves, cfg)

    def tree(self) -> dict:
        """``{"params", "batch_stats"}`` with numpy f32 leaves (views of
        one host copy per draw), as a ``.save`` holds them."""
        bufs = (self._k, self._b, self._g, self._be, self._m, self._v)
        host = {buf.data_ptr(): buf.cpu().numpy() for buf in bufs
                if buf.numel()}

        def np_of(t: torch.Tensor) -> np.ndarray:
            buf = next(b for b in bufs if b.numel() and b.data_ptr()
                       <= t.data_ptr() < b.data_ptr()
                       + b.numel() * b.element_size())
            start = (t.data_ptr() - buf.data_ptr()) // buf.element_size()
            flat = host[buf.data_ptr()][start:start + t.numel()]
            return flat.reshape(tuple(t.shape))

        params: dict = {}
        stats: dict = {}
        for path, leaf in self.leaves.items():
            if "value" in leaf:
                _put(params, path, np_of(leaf["value"]))
            elif "kernel" in leaf:
                _put(params, path, {k: np_of(v) for k, v in leaf.items()})
            else:
                _put(params, path, {"scale": np_of(leaf["scale"]),
                                    "bias": np_of(leaf["bias"])})
                if "mean" in leaf:
                    _put(stats, path, {"mean": np_of(leaf["mean"]),
                                       "var": np_of(leaf["var"]),
                                       "count": np.asarray(1, np.int32)})
        return {"params": params, "batch_stats": stats}


def default_box(cfg: dict, n: int, device) -> tuple:
    """(centres, scales) of the box centred on the crop, ``H / 200``."""
    w, h = cfg["image_size"]
    centers = torch.tensor([[w / 2.0, h / 2.0]], device=device).expand(n, 2)
    return centers, torch.full((n,), h / 200.0, device=device)


def vitpose_weights(cfg: dict, seed: int, device) -> tuple:
    """(ViTPoseWeights, Stats) with the head's BNs calibrated on seeded
    frames, ``final_layer`` scaled to the configuration's soft-argmax logit
    spread, and the lifter's part statistics those of the decoded
    calibration poses (as ``pose_hrnet.hrnet_weights``)."""
    w = ViTPoseWeights(cfg, seed, device)
    frames = torch.as_tensor(
        frame_pool(cfg, seed, CALIBRATION_FRAMES, "calibration"),
        device=device)
    n = CALIBRATION_FRAMES
    with torch.no_grad():
        w.net.calibrating = True
        heat = w.net.detector(frames.to(torch.float32) / 255.0)
        head = w.leaves[ref.HEAD + ("final_layer",)]
        offset = heat.mean(dim=(0, 2, 3))
        head["bias"].sub_(offset)
        heat = heat - offset.view(1, -1, 1, 1)
        t = cfg["softargmax_temperature"]
        spread = torch.stack([(t * heat.sum(dim=d)).std(dim=-1).mean()
                              for d in (-2, -1)]).mean()
        gain = cfg["assumed"]["softargmax_logit_std"] / float(spread)
        head["kernel"].mul_(gain)
        head["bias"].mul_(gain)
        w.net.forget_layouts()
        centers, scales = default_box(cfg, n, device)
        flat = mpii_to_lifter(ref.to_frame(softargmax(heat * gain, t),
                                           centers, scales,
                                           tuple(heat.shape[-2:])))
        mean_part = flat.mean(dim=0)
        std_part = flat.std(dim=0).clamp_min(1.0)
        w.net.lifter((flat - mean_part) / std_part, ("bilinear",))
        w.net.calibrating = False
    return w, Stats(mean_part, std_part, *_s_stats(seed, device))


def model_kw(cfg: dict) -> dict:
    """``End2EndServer``'s ``model_kw`` of the configuration: its widths,
    depth and crop."""
    b = cfg["backbone"]
    return {"embed_dim": b["embed_dim"], "depth": b["depth"],
            "heads": b["num_heads"], "image_size": tuple(b["img_size"])}


def build(run):
    """The seeded weights on the card (kept for the reference), and
    ``End2EndServer(variant="vitpose")`` on their ``.save`` tree in the
    cell's precision and batch sizes. A program without the variant
    raises before any weight is drawn. The program has no lower-precision
    path for ViTPose: the control replaces its answers in ``numbers``."""
    from bilinear_tpu_torch.models.detectors import detector
    from bilinear_tpu_torch.serving import End2EndServer

    cfg, wl = run.config, run.workload
    detector(cfg["variant"])
    w, stats = vitpose_weights(cfg, run.seed, run.device)
    run.state["weights"], run.state["stats"] = w, stats

    def host(t):
        return t.detach().cpu().numpy()

    return End2EndServer(
        w.tree(), host(stats.mean_part), host(stats.std_part),
        host(stats.mean_s), host(stats.std_s), variant=cfg["variant"],
        dtype=getattr(torch, wl["dtype"]), batch_sizes=wl["batch_sizes"],
        model_kw=model_kw(cfg), device=run.device)


def numbers(run, frames: np.ndarray, pose2d: np.ndarray,
            pose3d: np.ndarray) -> dict:
    """``pose.numbers`` against the ViTPose reference: the served 2D pose
    against the reference in f32, in units of the reference's own
    distance in the served precision; the served 3D pose against the
    reference's lifter on the served 2D pose. For the control the served
    answers are replaced by the reference's with fp8 (e4m3) operands in
    every Linear and conv, the precision below bf16."""
    w, stats = run.state["weights"], run.state["stats"]
    net = w.net
    r2, h2, l3 = [], [], []
    pose2d = np.array(pose2d, np.float32)
    pose3d = np.array(pose3d, np.float32)
    with torch.no_grad():
        for i in range(0, len(frames), BLOCK):
            f = torch.as_tensor(frames[i:i + BLOCK], device=run.device)
            if run.control:
                net.fp8 = True
                p2, p3 = ref.end2end(net, stats, f)
                net.fp8 = False
                pose2d[i:i + BLOCK] = p2.cpu().numpy()
                pose3d[i:i + BLOCK] = p3.cpu().numpy()
            r2.append(ref.end2end(net, stats, f)[0].cpu().numpy())
            net.dtype = getattr(torch, run.workload["dtype"])
            h2.append(ref.end2end(net, stats, f)[0].cpu().numpy())
            net.dtype = None
            served = torch.as_tensor(pose2d[i:i + BLOCK], device=run.device)
            l3.append(lift_of(net, stats, served).cpu().numpy())
    r2, h2, l3 = np.concatenate(r2), np.concatenate(h2), np.concatenate(l3)
    g2 = np.abs(pose2d.astype(np.float64) - r2).ravel()
    own = np.percentile(np.abs(h2.astype(np.float64) - r2), 75)
    g3 = np.abs(pose3d.astype(np.float64) - l3).ravel()
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
