"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The build directory (``csrc/build/``, listed in ``.gitignore``) keys every
library by a hash of its source and the shared headers, so an edited source
rebuilds and an unchanged one loads at once. Nothing is built when a module
is imported: only the first kernel launch (or ``build_all``) builds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    ``nvcc`` on the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (final path, tmp path, Popen or None)."""
    src, out = _lib_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, tmp, proc


def _finish(name: str, out: str, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> float:
    """Build every named source in parallel (one nvcc each, all started
    together) and load them. Returns the wall seconds it took."""
    t0 = time.monotonic()
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        try:
            for n, (out, tmp, proc) in started.items():
                _finish(n, out, tmp, proc)
        finally:
            for _, tmp, proc in started.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for n, (out, _, _) in started.items():
            _libs[n] = ctypes.CDLL(out)
    return time.monotonic() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
