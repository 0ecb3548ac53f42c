"""Seeded weights and statistics of a configuration, made on the device in a
few large draws, calibrated by the reference (``model.Net``'s
``calibrate``), and handed to the program as the JAX ``.save`` tree it
loads. The reference reads the same tensors; nothing here comes from the
program.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench import seeds
from portbench.reference import layout
from portbench.reference.model import Net, Stats, mpii_to_lifter, \
    softargmax, to_frame

CALIBRATION_FRAMES = 16
CALIBRATION_POSES = 4096


class Weights:
    """``leaves``: ``{path: {name: tensor}}`` on one device; ``tree()`` is
    the program's copy."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        self.cfg = cfg
        specs = list(layout.model_leaves(cfg))
        gen = torch.Generator(device=device)
        gen.manual_seed(seeds.torch_seed(seed, "weights"))
        kernels = [s for s in specs if s[1] != "bn"]
        norms = [s for s in specs if s[1] == "bn"]
        n_k = sum(math.prod(s[2]) for s in kernels)
        n_b = sum(s[2][-1] for s in kernels)
        n_c = sum(s[2][0] for s in norms)
        f32 = dict(device=device, dtype=torch.float32)
        # Four draws in all, sliced into the leaves below.
        self._k = torch.randn(n_k, generator=gen, **f32)
        self._b = torch.rand(n_b, generator=gen, **f32) * 2.0 - 1.0
        lo, hi = (math.log(v) for v in cfg["assumed"]["bn_scale_range"])
        self._g = torch.exp(torch.rand(n_c, generator=gen, **f32)
                            * (hi - lo) + lo)
        b_mean, b_std = cfg["assumed"]["bn_bias"]
        self._be = torch.randn(n_c, generator=gen, **f32) * b_std + b_mean
        self._m = torch.zeros(n_c, **f32)
        self._v = torch.ones(n_c, **f32)
        self.leaves: Dict[tuple, Dict[str, torch.Tensor]] = {}
        ok = ob = oc = 0
        for path, kind, shape in specs:
            if kind == "bn":
                c = shape[0]
                self.leaves[path] = {
                    name: buf[oc:oc + c] for name, buf in (
                        ("scale", self._g), ("bias", self._be),
                        ("mean", self._m), ("var", self._v))}
                oc += c
                continue
            n, fan_in = math.prod(shape), math.prod(shape[:-1])
            kernel = self._k[ok:ok + n].view(shape)
            kernel.mul_(math.sqrt(2.0 / fan_in))
            bias = self._b[ob:ob + shape[-1]]
            bias.mul_(1.0 / math.sqrt(fan_in))
            self.leaves[path] = {"kernel": kernel, "bias": bias}
            ok += n
            ob += shape[-1]
        self.net = Net(self.leaves, cfg["bn_eps"])

    def tree(self) -> dict:
        """``{"params", "batch_stats"}`` with numpy f32 leaves (views of
        one host copy per draw), as a ``.save`` holds them."""
        host = {id(buf): buf.cpu().numpy() for buf in
                (self._k, self._b, self._g, self._be, self._m, self._v)}

        def np_of(t: torch.Tensor, buf: torch.Tensor) -> np.ndarray:
            start = (t.data_ptr() - buf.data_ptr()) // buf.element_size()
            flat = host[id(buf)][start:start + t.numel()]
            return flat.reshape(tuple(t.shape))

        params: dict = {}
        stats: dict = {}
        for path, leaf in self.leaves.items():
            if "kernel" in leaf:
                node = {"kernel": np_of(leaf["kernel"], self._k),
                        "bias": np_of(leaf["bias"], self._b)}
                _put(params, path, node)
            else:
                _put(params, path, {"scale": np_of(leaf["scale"], self._g),
                                    "bias": np_of(leaf["bias"], self._be)})
                _put(stats, path, {"mean": np_of(leaf["mean"], self._m),
                                   "var": np_of(leaf["var"], self._v),
                                   "count": np.asarray(1, np.int32)})
        return {"params": params, "batch_stats": stats}


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _s_stats(seed: int, device) -> tuple:
    r = seeds.rng(seed, "s-stats")
    mean_s = r.normal(0.0, 50.0, 48).astype(np.float32)
    std_s = r.uniform(50.0, 300.0, 48).astype(np.float32)
    return (torch.as_tensor(mean_s, device=device),
            torch.as_tensor(std_s, device=device))


def lifter_weights(cfg: dict, seed: int, device, pool: torch.Tensor
                   ) -> tuple:
    """lift-1024x2: (Weights calibrated on the pool's first poses, Stats).
    ``pool``: (N, 32) image-space poses made by ``lifter_pool``."""
    w = Weights(cfg, seed, device)
    stats = Stats(*lifter_part_stats(seed, device), *_s_stats(seed, device))
    with torch.no_grad():
        x = (pool[:CALIBRATION_POSES] - stats.mean_part) / stats.std_part
        w.net.calibrating = True
        w.net.lifter(x)
        w.net.calibrating = False
    return w, stats


def lifter_part_stats(seed: int, device) -> tuple:
    r = seeds.rng(seed, "part-stats")
    mean = r.uniform(200.0, 800.0, 32).astype(np.float32)
    std = r.uniform(20.0, 200.0, 32).astype(np.float32)
    return (torch.as_tensor(mean, device=device),
            torch.as_tensor(std, device=device))


def lifter_pool(seed: int, n: int, device) -> torch.Tensor:
    """(n, 32) image-space poses: the part statistics' mean plus their
    standard deviation times a standard normal draw."""
    mean, std = lifter_part_stats(seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.torch_seed(seed, "poses"))
    return mean + std * torch.randn((n, 32), generator=gen, device=device)


def end2end_weights(cfg: dict, seed: int, device) -> tuple:
    """e2e-hg8x256: (Weights, Stats) with every BN calibrated on seeded
    frames, the last heatmap head scaled to the configuration's soft-argmax
    logit spread, and the lifter's part statistics those of the decoded
    calibration poses."""
    w = Weights(cfg, seed, device)
    frames = torch.as_tensor(
        seeds.frame_pool(seed, CALIBRATION_FRAMES, "calibration"),
        device=device)
    n = CALIBRATION_FRAMES
    with torch.no_grad():
        images = frames.to(torch.float32) / 255.0
        w.net.calibrating = True
        heat = w.net.detector(images, cfg["nStack"])
        # A trained head's heatmaps are near zero away from the joints:
        # centre each joint's map, then scale it to the logit spread.
        head = w.leaves[("hourglass", f"htmap_{cfg['nStack'] - 1}")]
        offset = heat.mean(dim=(0, 2, 3))
        head["bias"].sub_(offset)
        heat = heat - offset.view(1, -1, 1, 1)
        t = cfg["softargmax_temperature"]
        spread = (t * heat.sum(dim=-2)).std(dim=-1).mean()
        gain = cfg["assumed"]["softargmax_logit_std"] / float(spread)
        head["kernel"].mul_(gain)
        head["bias"].mul_(gain)
        w.net.forget_layouts()
        centers = torch.full((n, 2), cfg["inputRes"] / 2.0, device=device)
        scales = torch.full((n,), cfg["inputRes"] / 200.0, device=device)
        flat = mpii_to_lifter(to_frame(softargmax(heat * gain, t), centers,
                                       scales, cfg["outputRes"]))
        mean_part = flat.mean(dim=0)
        std_part = flat.std(dim=0).clamp_min(1.0)
        w.net.lifter((flat - mean_part) / std_part, ("bilinear",))
        w.net.calibrating = False
    return w, Stats(mean_part, std_part, *_s_stats(seed, device))
