"""Environment self-check: ``python -m bilinear_tpu_torch.cli.doctor``
(counterpart of ``bilinear_tpu/cli/doctor.py``).

Each probe measures one thing a mis-provisioned host gets wrong, once, up
front, and the report is ONE JSON object on stdout:

- ``platform``    torch and CUDA versions, the device's
                  name, compute capability and count, and its power limit as
                  ``nvidia-smi`` reads it (a card below 700 W runs slower);
- ``memory``      free and total device memory per card
                  (``torch.cuda.mem_get_info``);
- ``dispatch``    the round trip of a tiny kernel: launch and synchronise;
- ``sync``        whether ``torch.cuda.synchronize`` waits for queued work
                  (a queued matmul chain, timed with and without it);
- ``transfer``    pinned host-to-device and device-to-host MB/s;
- ``matmul``      bf16 TFLOP/s of an n x n product by CUDA events, beside
                  the H100's dense peak of 989;
- ``kernels``     whether each CUDA library of the current sources
                  (``csrc/*.cu``) and the host packer (``native/``) is built,
                  and with ``--build``, how long building the missing ones
                  takes (JAX's ``compile_cache`` probe has no counterpart:
                  nothing here compiles at run time but these);
- ``checkpoints`` with ``--run-dir``: the newest epoch and the finalized
                  marker of ``{run_dir}/parameter``, as JAX's.

The device is the card; ``--device cpu`` is an explicit request (the tests
make it): the device probes then time the CPU and say so. The exit code is
0 when every probe ran (warnings are advisory), 1 if any raised.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

H100_BF16_TFLOPS = 989.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe_platform(dev: torch.device) -> dict:
    out = {"torch_version": torch.__version__,
           "cuda_version": torch.version.cuda, "device": str(dev),
           "cuda_available": torch.cuda.is_available(),
           "device_count": torch.cuda.device_count()}
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["capability"] = list(torch.cuda.get_device_capability(dev))
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30)
            out["nvidia_smi"] = smi.stdout.strip().splitlines()
        except (OSError, subprocess.TimeoutExpired) as e:
            out["nvidia_smi"] = None
            out["warning"] = f"nvidia-smi unavailable ({e}): power limit " \
                             "unknown"
    else:
        out["warning"] = "CPU requested: the device probes time the CPU"
    return out


def probe_memory(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"per_device": [], "note": "no device memory on the CPU"}
    per = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        per.append({"index": i, "free_bytes": int(free),
                    "total_bytes": int(total)})
    return {"per_device": per}


def probe_dispatch(dev: torch.device, reps: int = 50) -> dict:
    x = torch.zeros(1, device=dev)
    for _ in range(5):
        x.add_(1.0)
        _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        x.add_(1.0)
        _sync(dev)
    rtt = (time.perf_counter() - t0) / reps
    return {"round_trip_ms": rtt * 1e3, "value": float(x.item())}


def probe_sync(dev: torch.device, n: int = 4096, chain: int = 16) -> dict:
    """Queue ``chain`` n x n products (milliseconds of device work), then
    time the return of the launches and the synchronise after them: a
    synchronise that waits takes about the work's time (the device time by
    CUDA events beside it); one that returns at once leaves it running."""
    a = torch.randn(n, n, device=dev)

    def run():
        b = a
        for _ in range(chain):
            b = b @ a
        return b

    for _ in range(2):
        run().sum().item()
    t0 = time.perf_counter()
    b = run()
    t1 = time.perf_counter()
    _sync(dev)
    t2 = time.perf_counter()
    b.sum().item()
    t3 = time.perf_counter()
    out = {"launch_s": t1 - t0, "synchronize_s": t2 - t1,
           "fetch_after_sync_s": t3 - t2}
    if dev.type == "cuda":
        from bilinear_tpu_torch.utils.profiling import cuda_time_ms

        device_s = cuda_time_ms(run, iters=1, warmup=0) / 1e3
        out["device_s"] = device_s
        out["synchronize_waits"] = t2 - t0 >= 0.9 * device_s
    return out


def probe_transfer(dev: torch.device, mb: int = 32) -> dict:
    n = mb * (1 << 20) // 4
    host = torch.empty(n, dtype=torch.float32,
                       pin_memory=dev.type == "cuda").fill_(1.0)
    d = host.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    d = host.to(dev, non_blocking=True)
    _sync(dev)
    h2d = time.perf_counter() - t0
    back = torch.empty(n, dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    t0 = time.perf_counter()
    back.copy_(d, non_blocking=True)
    _sync(dev)
    d2h = time.perf_counter() - t0
    out = {"mb": mb, "pinned": dev.type == "cuda",
           "h2d_mb_s": mb / max(h2d, 1e-9), "d2h_mb_s": mb / max(d2h, 1e-9)}
    if dev.type != "cuda":
        out["note"] = "CPU requested: not a device figure"
    return out


def probe_matmul(dev: torch.device, n: int = 4096, iters: int = 20) -> dict:
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    a = torch.randn(n, n, device=dev, dtype=dtype)
    b = torch.randn(n, n, device=dev, dtype=dtype)
    flops = 2.0 * n ** 3
    if dev.type == "cuda":
        from bilinear_tpu_torch.utils.profiling import cuda_time_ms

        ms = cuda_time_ms(lambda: a @ b, iters=iters)
        return {"n": n, "dtype": "bfloat16", "ms": ms,
                "tflops": flops / ms / 1e9,
                "h100_dense_peak_tflops": H100_BF16_TFLOPS,
                "share_of_peak": flops / ms / 1e9 / H100_BF16_TFLOPS}
    a @ b
    t0 = time.perf_counter()
    a @ b
    s = time.perf_counter() - t0
    return {"n": n, "dtype": "float32", "ms": s * 1e3,
            "cpu_gflops": flops / s / 1e9,
            "note": "CPU requested: not a device figure"}


def probe_kernels(build: bool = False) -> dict:
    """Each CUDA library of the current sources and the host packer: built
    or not; with ``build``, build the missing ones and time it."""
    from bilinear_tpu_torch import native
    from bilinear_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    out = {"cuda": {n: os.path.exists(_build._lib_path(n)[1])
                    for n in names},
           "packer": os.path.exists(native.library_path())}
    if build:
        t0 = time.perf_counter()
        native.build()
        out["packer_build_s"] = time.perf_counter() - t0
        out["cuda_build_s"] = _build.build_all(names)
    return out


def probe_checkpoints(run_dir: str) -> dict:
    from bilinear_tpu_torch.io.checkpoint import is_finalized, latest_epoch

    parameter_dir = os.path.join(run_dir, "parameter")
    epoch = latest_epoch(parameter_dir)
    out = {
        "parameter_dir": parameter_dir,
        "latest_epoch": epoch,
        "finalized": is_finalized(parameter_dir),
    }
    if epoch <= 0 and not out["finalized"]:
        out["warning"] = ("no checkpoints found — a fresh run will init "
                          "from scratch")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="",
                   help="'' = the card (raises without one); 'cpu' to "
                        "probe the CPU")
    p.add_argument("--mb", type=int, default=32, help="transfer probe size")
    p.add_argument("--matmul-n", type=int, default=4096)
    p.add_argument("--sync-n", type=int, default=4096)
    p.add_argument("--run-dir", default=None,
                   help="scan this run's checkpoint directory")
    p.add_argument("--build", action="store_true",
                   help="build the missing kernel libraries and time it")
    p.add_argument("--skip", nargs="*", default=[],
                   help="probe names to skip (e.g. --skip matmul transfer)")
    args = p.parse_args(argv)
    from bilinear_tpu_torch.device import resolve_device

    dev = resolve_device(args.device or None)
    probes = {
        "platform": lambda: probe_platform(dev),
        "memory": lambda: probe_memory(dev),
        "dispatch": lambda: probe_dispatch(dev),
        "sync": lambda: probe_sync(dev, args.sync_n),
        "transfer": lambda: probe_transfer(dev, args.mb),
        "matmul": lambda: probe_matmul(dev, args.matmul_n),
        "kernels": lambda: probe_kernels(args.build),
    }
    if args.run_dir:
        probes["checkpoints"] = lambda: probe_checkpoints(args.run_dir)

    report, failed = {}, False
    for name, fn in probes.items():
        if name in args.skip:
            report[name] = {"skipped": True}
            continue
        try:
            report[name] = fn()
        except Exception as e:  # keep the other probes alive
            report[name] = {"error": f"{type(e).__name__}: {e}"}
            failed = True
        if "warning" in report[name]:
            print(f"[doctor] {name}: {report[name]['warning']}",
                  file=sys.stderr)

    print(json.dumps(report, indent=2))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
