"""Batched crop + rotate + resize (counterpart of ``crop_image``,
``crop_batch_gather``, ``crop_batch`` and ``hflip`` in
``bilinear_tpu/ops/affine.py``; plain torch ops, as they are XLA, not
Pallas, in the JAX package).

``crop_image`` / ``crop_batch_gather`` evaluate the affine map at every
output pixel and gather bilinearly, zero outside the source (JAX's
``map_coordinates(order=1, mode="constant")``): the semantics oracle of the
batched crop, kept for tests. ``crop_batch`` is the path the trainers and
servers take:

The reference's PIL chain (integer box crop -> pad -> rotate -> centre crop
-> resize) is one affine map from output to source pixels. It factors into
an isotropic scale + translate, done as two batched matmuls with per-sample
tent interpolation matrices onto an expanded (E, E) grid that covers the
rotated field of view, and a rotation about the grid centre done as three
shears, ``R(t) = ShearX(-tan(t/2)) ShearY(sin t) ShearX(-tan(t/2))``, each a
per-row fractional shift with zero padding; then a centre crop. Integer
truncation of the box corners and PIL's pixel-centre conventions are kept.
Images are NHWC, as in the JAX package.
"""
from __future__ import annotations

import torch

_EXPAND_RATIO = 1.5  # covers |rotation| <= 60 deg


def _dst_to_src_coords(center_xy: torch.Tensor, scale, rotate_deg,
                       res: int):
    """(ys, xs) source coordinates of the (res, res) output pixels: PIL's
    resize of the integer-truncated box, then its rotation (content CCW by
    ``rotate_deg``) about the box centre."""
    dev = center_xy.device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    rotate_deg = torch.as_tensor(rotate_deg, dtype=torch.float32, device=dev)
    half = 100.0 * scale
    ul = torch.trunc(center_xy - half)
    br = torch.trunc(center_xy + half)
    box = br - ul
    d = torch.arange(res, dtype=torch.float32, device=dev)
    xb = ((d[None, :] + 0.5) * (box[0] / res) - 0.5).expand(res, res)
    yb = ((d[:, None] + 0.5) * (box[1] / res) - 0.5).expand(res, res)
    cx = (box[0] - 1.0) / 2.0
    cy = (box[1] - 1.0) / 2.0
    theta = torch.deg2rad(rotate_deg)
    cos, sin = torch.cos(theta), torch.sin(theta)
    dxb, dyb = xb - cx, yb - cy
    xs = cx + cos * dxb - sin * dyb
    ys = cy + sin * dxb + cos * dyb
    return ys + ul[1], xs + ul[0]


def _bilinear_zero(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """(H, W, C) sampled at (ys, xs): the four neighbours' values (zero
    outside the image) weighted by the fractions, summed in JAX's order
    ((y0, x0), (y0, x1), (y1, x0), (y1, x1))."""
    h, w = image.shape[:2]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    iy, ix = y0.long(), x0.long()
    out = None
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yi, xi = iy + dy, ix + dx
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
            v = torch.where(valid[..., None], v, torch.zeros_like(v))
            term = (wy * wx)[..., None] * v
            out = term if out is None else out + term
    return out


def crop_image(image: torch.Tensor, center_xy, scale, rotate_deg=0.0,
               res: int = 256) -> torch.Tensor:
    """(H, W, C) float -> (res, res, C), zero outside the source."""
    image = image.float()
    center = torch.as_tensor(center_xy, dtype=torch.float32,
                             device=image.device)
    ys, xs = _dst_to_src_coords(center, scale, rotate_deg, res)
    return _bilinear_zero(image, ys, xs)


def crop_batch_gather(images: torch.Tensor, centers_xy: torch.Tensor,
                      scales: torch.Tensor, rotates_deg: torch.Tensor,
                      res: int = 256) -> torch.Tensor:
    """``crop_image`` of every sample: (B, H, W, C) -> (B, res, res, C) f32;
    uint8 input is scaled to [0, 1] first. Exact everywhere, one gather per
    pixel: the semantics oracle of ``crop_batch``."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return torch.stack([crop_image(im, c, s, r, res) for im, c, s, r in
                        zip(images, centers_xy, scales, rotates_deg)])


def _tent_matrix(start, pitch, in_size: int, out_size: int):
    """(B, out, in) weights tent((s - src_o) / support), src_o = start +
    o * pitch, support = max(1, pitch); zero outside the source, rows
    normalised by max(sum, 1)."""
    dev = start.device
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    s = torch.arange(in_size, dtype=torch.float32, device=dev)
    src = start[:, None] + o[None, :] * pitch[:, None]
    sup = torch.clamp(pitch, min=1.0)[:, None, None]
    d = (s[None, None, :] - src[:, :, None]) / sup
    w = torch.clamp(1.0 - d.abs(), min=0.0)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)


def _shear_rows(img, shift, pad: int):
    """out[b, v, u] = in[b, v, u + shift[b, v]] with zero padding and a
    linear blend of the two neighbours for the fraction. img (B, E, E, C)."""
    b, e, ew, c = img.shape
    t = torch.clamp(shift + pad, 0.0, 2.0 * pad)
    n = torch.floor(t)
    f = (t - n)[..., None, None]
    n = n.long()
    padded = torch.nn.functional.pad(img, (0, 0, pad, 2 * pad + 1))
    u = torch.arange(ew, device=img.device)
    idx = (u[None, None, :] + n[..., None])  # (B, E, Ew) into padded
    idx = idx[..., None].expand(b, e, ew, c)
    lo = torch.gather(padded, 2, idx)
    hi = torch.gather(padded, 2, idx + 1)
    return (1.0 - f) * lo + f * hi


def _rotate_three_shear(img, theta, center: float):
    """Rotate (B, E, E, C) about (center, center) by the dst->src map
    [[cos, -sin], [sin, cos]]."""
    e = img.shape[1]
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    idx = torch.arange(e, dtype=torch.float32, device=img.device) - center
    pad = int(0.87 * e / 2) + 8

    def shear_x(im, coef):
        return _shear_rows(im, coef[:, None] * idx[None, :], pad)

    def shear_y(im, coef):
        out = _shear_rows(im.transpose(1, 2), coef[:, None] * idx[None, :],
                          pad)
        return out.transpose(1, 2)

    return shear_x(shear_y(shear_x(img, a), b), a)


def crop_batch(images: torch.Tensor, centers_xy: torch.Tensor,
               scales: torch.Tensor, rotates_deg: torch.Tensor,
               res: int = 256) -> torch.Tensor:
    """(B, H, W, C) -> (B, res, res, C) f32. uint8 input is rescaled to
    [0, 1] here, on the device."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    b, h, w, c = images.shape
    e = int(res * _EXPAND_RATIO)
    e += e % 2
    pad = (e - res) // 2

    half = 100.0 * scales
    ul = torch.trunc(centers_xy - half[:, None])
    br = torch.trunc(centers_xy + half[:, None])
    box = br - ul
    px = box[:, 0] / res
    py = box[:, 1] / res
    start_x = ul[:, 0] + (-pad + 0.5) * px - 0.5
    start_y = ul[:, 1] + (-pad + 0.5) * py - 0.5
    wx = _tent_matrix(start_x, px, w, e)  # (B, E, W)
    wy = _tent_matrix(start_y, py, h, e)  # (B, E, H)
    t = torch.einsum("bvy,byxc->bvxc", wy, images)
    expanded = torch.einsum("bux,bvxc->bvuc", wx, t)  # (B, E, E, C)

    theta = torch.deg2rad(rotates_deg)
    if bool((theta != 0.0).any()):
        expanded = _rotate_three_shear(expanded, theta,
                                       pad + res / 2.0 - 0.5)
    return expanded[:, pad:pad + res, pad:pad + res, :]


def hflip(images: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of (..., H, W, C) images."""
    return torch.flip(images, dims=[-2])

