"""Seeded draws. Every stream is keyed by (seed, purpose), so two purposes
never share draws and a seed of any size (past 32 bits) works."""
from __future__ import annotations

import zlib

import numpy as np

FRAME = (256, 256, 3)


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A numpy generator for one purpose of one run."""
    return np.random.default_rng([int(seed), zlib.crc32(purpose.encode())])


def torch_seed(seed: int, purpose: str) -> int:
    """A 62-bit seed for a ``torch.Generator``, keyed like ``rng``."""
    return int(rng(seed, purpose).integers(2 ** 62))


def frame_pool(seed: int, n: int, purpose: str = "frames") -> np.ndarray:
    """(n, 256, 256, 3) u8 frames: a smooth random field (a 9 x 9 grid of
    colours, bilinearly interpolated) with a little per-pixel noise, as a
    camera's frames are smooth at the scale of the detector's stem."""
    r = rng(seed, purpose)
    grid = r.uniform(0.0, 255.0, size=(n, 9, 9, 3)).astype(np.float32)
    pos = np.linspace(0.0, 8.0, FRAME[0], dtype=np.float32)
    i0 = np.minimum(pos.astype(np.int64), 7)
    interp = np.zeros((FRAME[0], 9), np.float32)
    interp[np.arange(FRAME[0]), i0] = 1.0 - (pos - i0)
    interp[np.arange(FRAME[0]), i0 + 1] += pos - i0
    field = np.einsum("hi,nijc,wj->nhwc", interp, grid, interp,
                      optimize=True)
    field += r.integers(-12, 13, size=field.shape, dtype=np.int8)
    return np.clip(field, 0, 255).astype(np.uint8)
