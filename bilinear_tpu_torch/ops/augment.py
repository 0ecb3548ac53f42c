"""Training augmentation (counterpart of ``bilinear_tpu/ops/augment.py``;
plain torch ops, as they are XLA, not Pallas, in the JAX package).

Sampling is split from application, so that the same draws can be fed to
this package and to the JAX one:

- ``sample_geometry(generator, batch)``: scale *= 2^rand(0.25), rotation
  rand(30 deg) w.p. 0.4 else 0, flip w.p. ``flip_prob``, with ``rand(x) =
  clip(N(0, 1) x, -2x, 2x)`` (the reference's MPII/util.py:10-11);
- ``sample_color_jitter(generator, batch)``: ColorJitter(.3, .3, .3, .3)
  factors per sample and one order of the four ops per batch (24 orders),
  as ``color_jitter_batch`` draws them;
- ``apply_color_jitter(images, params)``: the application.

The draws come from a ``torch.Generator``; they are not JAX's bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_GRAY = (0.299, 0.587, 0.114)
ORDERS = [(a, b, c, d) for a in range(4) for b in range(4) for c in range(4)
          for d in range(4) if len({a, b, c, d}) == 4]


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def _uniform(gen: torch.Generator, shape, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def rand(gen: torch.Generator, x: float, shape, device=None) -> torch.Tensor:
    """Truncated gaussian: clip(N(0, 1) x, -2x, 2x)."""
    return torch.clamp(_normal(gen, shape, device) * x, -2 * x, 2 * x)


class AugmentParams(NamedTuple):
    scale_factor: torch.Tensor  # multiply the annotation scale by this
    rotate_deg: torch.Tensor
    flip: torch.Tensor  # bool


def sample_geometry(gen: torch.Generator, batch: int = 1,
                    scale_jitter: float = 0.25, max_rotate: float = 30.0,
                    rotate_prob: float = 0.4, flip_prob: float = 0.4,
                    device=None) -> AugmentParams:
    """Per-sample geometric draws (train only)."""
    scale_factor = 2.0 ** rand(gen, scale_jitter, (batch,), device)
    rot = rand(gen, max_rotate, (batch,), device)
    gate = torch.rand((batch,), generator=gen, device=device) <= rotate_prob
    rotate = torch.where(gate, rot, 0.0)
    flip = torch.rand((batch,), generator=gen, device=device) <= flip_prob
    return AugmentParams(scale_factor, rotate, flip)


class JitterParams(NamedTuple):
    brightness: torch.Tensor  # (B,) factors
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor  # (B,) shifts
    order: int  # index into ORDERS, one per batch


def sample_color_jitter(gen: torch.Generator, batch: int,
                        brightness: float = 0.3, contrast: float = 0.3,
                        saturation: float = 0.3, hue: float = 0.3,
                        device=None) -> JitterParams:
    def factor(x):
        return _uniform(gen, (batch,), max(0.0, 1 - x), 1 + x, device)

    fb, fc, fs = factor(brightness), factor(contrast), factor(saturation)
    fh = _uniform(gen, (batch,), -hue, hue, device)
    order = int(torch.randint(len(ORDERS), (1,), generator=gen,
                              device=device))
    return JitterParams(fb, fc, fs, fh, order)


def _blend(img, other, factor):
    return torch.clamp(factor * img + (1.0 - factor) * other, 0.0, 1.0)


def _gray(img):
    w = torch.tensor(_GRAY, dtype=img.dtype, device=img.device)
    return torch.tensordot(img, w, dims=([-1], [0]))


def adjust_brightness(img, factor):
    return _blend(img, 0.0, factor)


def adjust_contrast(img, factor):
    mean = _gray(img).mean(dim=(-2, -1), keepdim=True)[..., None]
    return _blend(img, mean, factor)


def adjust_saturation(img, factor):
    return _blend(img, _gray(img)[..., None], factor)


def rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def pick(options):
        out = options[0]
        for idx in range(1, 6):
            out = torch.where(i == idx, options[idx], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-1)


def adjust_hue(img, shift):
    hsv = rgb_to_hsv(img)
    h = (hsv[..., 0] + shift) % 1.0
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def apply_color_jitter(imgs: torch.Tensor, jp: JitterParams) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1]: the four ops in the batch's order, each with
    its per-sample factor."""
    ops = [
        lambda im: adjust_brightness(im, jp.brightness[:, None, None, None]),
        lambda im: adjust_contrast(im, jp.contrast[:, None, None, None]),
        lambda im: adjust_saturation(im, jp.saturation[:, None, None, None]),
        lambda im: adjust_hue(im, jp.hue[:, None, None]),
    ]
    for op_idx in ORDERS[jp.order]:
        imgs = ops[op_idx](imgs)
    return imgs


def flip_keypoints_x(keypoints_xy: torch.Tensor, center_x: torch.Tensor,
                     swap) -> torch.Tensor:
    """Mirror keypoints about x = center_x and apply the L/R joint swap."""
    mirrored = keypoints_xy.clone()
    mirrored[..., 0] = 2.0 * center_x - keypoints_xy[..., 0]
    idx = torch.as_tensor(swap, dtype=torch.long, device=keypoints_xy.device)
    return mirrored.index_select(-2, idx)
