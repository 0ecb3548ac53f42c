"""ctypes loader and first-use builder of the host packer
(``native/fastpack.cpp``; counterpart of ``bilinear_tpu/native``).

The library is built with ``g++ -O3 -march=native`` (the JAX package's
flags, so the two packages' canvases agree bit for bit on one machine) into
``native/build/`` (listed in ``.gitignore``), keyed by a hash of the source
and the flags: an edited source rebuilds, an unchanged one loads at once.
Concurrent first builds write per-process temporary names and publish with
``os.replace``. Unlike the JAX package there is no silent fallback: a
failed build raises with the compiler's output. ``data/pipeline.py`` keeps
the numpy copy of the same arithmetic as the packer's plain version, which
the tests hold it against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "fastpack.cpp")
BUILD_DIR = os.path.join(HERE, "build")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None  # of this process's build, if it built


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"fastpack-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Build the library unless it is built; returns its path. Raises
    ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    global BUILD_SECONDS
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    t0 = time.monotonic()
    try:
        proc = subprocess.run(["g++", *FLAGS, "-o", tmp, SRC],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host packer "
                           "(native/fastpack.cpp) cannot be built") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed for native/fastpack.cpp:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.monotonic() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i = ctypes.c_int
            lib.resize_linear_u8.argtypes = [u8p, i, i, i, u8p, i, i]
            lib.resize_linear_u8.restype = None
            lib.pack_canvas_f32.argtypes = [u8p, i, i, i, f32p, i, i, i]
            lib.pack_canvas_f32.restype = None
            lib.pack_canvas_u8.argtypes = [u8p, i, i, i, u8p, i, i, i]
            lib.pack_canvas_u8.restype = None
            _lib = lib
    return _lib


def resize_linear_u8(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(sh, sw, ch) uint8 -> (dh, dw, ch) uint8, PIL-BILINEAR-compatible
    (within one step of PIL's rounding)."""
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, ch = src.shape
    dst = np.empty((dh, dw, ch), np.uint8)
    load().resize_linear_u8(src, sh, sw, ch, dst, dh, dw)
    return dst


def pack_canvas_f32(src: np.ndarray, canvas: int, ul_x: int,
                    ul_y: int) -> np.ndarray:
    """(sh, sw, ch) uint8 region starting at (ul_x, ul_y) -> zero-padded
    (canvas, canvas, ch) float32 in [0, 1]."""
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, ch = src.shape
    dst = np.empty((canvas, canvas, ch), np.float32)
    load().pack_canvas_f32(src, sh, sw, ch, dst, canvas, int(ul_x),
                           int(ul_y))
    return dst


def pack_canvas_u8(src: np.ndarray, canvas: int, ul_x: int,
                   ul_y: int) -> np.ndarray:
    """(sh, sw, ch) uint8 region starting at (ul_x, ul_y) -> zero-padded
    (canvas, canvas, ch) uint8."""
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, ch = src.shape
    dst = np.empty((canvas, canvas, ch), np.uint8)
    load().pack_canvas_u8(src, sh, sw, ch, dst, canvas, int(ul_x),
                          int(ul_y))
    return dst
