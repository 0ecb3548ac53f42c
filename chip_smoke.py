#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bilinear_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is swallowed):
1. Card: name and power limit from nvidia-smi; TF32 switched off for
   matmuls and cuDNN, so the plain f32 versions run in full f32.
2. Build: both CUDA sources (csrc/lifting.cu, csrc/lifting_int8.cu), one
   nvcc each, in parallel.
3. Kernels vs their plain PyTorch versions, on the card, in the working
   type: K1 bf16 and f32, K2 dynamic and static, at n in NS, full-width
   weights with scrambled BN statistics from a seeded torch.Generator.
4. The slice: a synthetic H36M dataset and an epoch-1 checkpoint written
   by the port; for each serving mode the daemon of cli/serve.py answers
   /v1/lift requests (JSON and .npy, concurrent ones coalesced) through
   PoseHTTPServer, each answer is checked against the plain path, the
   kernel's launch counter must rise, epoch 2 hot-reloads through
   /admin/reload, and the valid-split MPJPE of the served and plain paths
   is printed.
5. Times with CUDA events after warm-up at n = 256 (the daemon's max_rows)
   and n = 65536, beside each kernel's bound, its plain version and, as a
   labelled yardstick, the cuBLAS chain of six F.linear calls in bf16.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or bilinear_tpu.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NS = (1, 100, 512, 700, 4096, 65536)
SERVE_ROWS = (1, 16, 256)
TIME_NS = (256, 65536)

# H100 SXM published dense peaks (NVIDIA data sheet) at 700 W.
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

H, IN_F, OUT_F = 1024, 32, 48
MACS_ENC_DEC = IN_F * H + H * OUT_F
MACS_HIDDEN = 4 * H * H


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ setup


def random_state_dict(seed: int):
    """Full-width BilinearUnit weights with scrambled BN statistics
    (running mean ~N(0, 0.3^2), var ~U(0.5, 1.5)), from a seed."""
    import torch
    from bilinear_tpu_torch.models.bilinear import BilinearUnit

    gen = torch.Generator().manual_seed(seed)
    model = BilinearUnit(generator=gen)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.randn(v.shape, generator=gen) * 0.3)
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
        elif k.endswith(".1.weight"):  # BN gamma
            v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    return sd


def gate_close(name, out, ref, mean_tol, max_tol=None, p99_tol=None):
    """Mean |diff| (and max or 99th percentile) relative to mean |ref|."""
    import torch

    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    d = (out - ref).abs()
    scale = float(ref.abs().mean()) or 1.0
    mean, mx = float(d.mean()), float(d.max())
    msg = f"{name}: max|d| {mx:.3e} mean|d| {mean:.3e} (mean|ref| {scale:.3e})"
    ok = mean <= mean_tol * scale
    if max_tol is not None:
        ok = ok and mx <= max_tol * scale
    if p99_tol is not None:
        p99 = float(torch.quantile(d.flatten()[:1 << 24], 0.99))
        msg += f" p99 {p99:.3e}"
        ok = ok and p99 <= p99_tol * scale
    log("  " + msg)
    if not ok:
        raise AssertionError(msg + " — out of tolerance")
    return mx, mean


# ------------------------------------------------------------ phase 3


def check_kernels(params, stats):
    """Each kernel against its plain version on the same CUDA inputs.
    Returns {kernel: max_abs_err over all n}."""
    import torch
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x_all = torch.randn((max(NS), IN_F), generator=gen, device=dev)
    errs = {}

    # Tolerances. f32: the same f32 arithmetic summed in another order
    # (~1e-6 relative expected); bf16: a value at a bf16 rounding boundary
    # may round one step apart and carry (the CPU tests' gate against the
    # TPU kernel); int8: an activation at a quantization boundary may
    # round one int8 step apart (gate of tests/test_torch_port_int8.py).
    for dtype, name, tol in ((torch.bfloat16, "lifting_bf16", (2e-3, 0.06)),
                             (torch.float32, "lifting_f32", (1e-4, 1e-3))):
        w = pl.prepare_weights(params, stats, dtype, device=dev)
        full = None
        err = 0.0
        for n in sorted(NS, reverse=True):
            x = x_all[:n].to(dtype)
            out = pl.lifting_forward_cuda(w, x)
            torch.cuda.synchronize()
            ref = pl.lifting_forward_ref(w, x)
            mx, _ = gate_close(f"{name} n={n}", out, ref, *tol)
            err = max(err, mx)
            if full is None:
                full = out
            elif not torch.equal(out, full[:n]):  # rows are independent
                raise AssertionError(f"{name}: rows of n={n} differ from "
                                     f"the same rows of a larger batch")
        errs[name] = err

    wq = pq.prepare_weights_int8(params, stats, device=dev)
    err = 0.0
    for n in NS:
        x = x_all[:n]
        out = pq.lifting_forward_int8(x=x, prepared=wq)
        torch.cuda.synchronize()
        ref = pq.lifting_forward_int8_ref(wq, x)
        mx, _ = gate_close(f"lifting_int8_dynamic n={n}", out, ref, 2e-3,
                           p99_tol=2e-2)
        err = max(err, mx)
    errs["lifting_int8_dynamic"] = err
    check_group_amax(params, stats, x_all)

    calib = x_all[:4096]
    scales = pq.calibrate_scales(wq, calib)  # kernel: one group of all rows
    plain_amax = []
    pq.forward_chain(wq, (None,) * 4, calib[None], plain_amax)
    plain_scales = tuple(pq._round_sig(max(float(a), 1e-12) / 127.0)
                         for a in torch.cat(plain_amax))
    log(f"  calibrate_scales kernel {scales} plain {plain_scales}")
    for a, b in zip(scales, plain_scales):
        if abs(a - b) > 1.01 * _unit3(max(a, b)):
            raise AssertionError("calibrated scales disagree")
    err = 0.0
    for n in NS:
        x = x_all[:n]
        out = pq.lifting_forward_int8(x=x, prepared=wq, static_scales=scales)
        torch.cuda.synchronize()
        ref = pq.lifting_forward_int8_ref(wq, x, scales)
        mx, _ = gate_close(f"lifting_int8_static n={n}", out, ref, 2e-3,
                           p99_tol=2e-2)
        err = max(err, mx)
    errs["lifting_int8_static"] = err
    return errs, scales


def _unit3(v: float) -> float:
    """One unit in the 3rd significant digit of v."""
    import math

    return 10 ** (math.floor(math.log10(abs(v))) - 2)


def check_group_amax(params, stats, x_all):
    """The dynamic kernel's per-group amax (with its one padding row)
    against the plain version's (with the JAX path's zero padding rows),
    under weights where the padding rows hold the last group's amax."""
    import copy

    import torch
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    params = copy.deepcopy(params)
    params["encode"]["linear"]["bias"][0] = 30.0
    params["encode"]["linear"]["kernel"][:, 0] = 1.0
    wq = pq.prepare_weights_int8(params, stats, device="cuda")
    for n in (100, 700):
        x = -x_all[:n].abs()
        xb = x.to(torch.bfloat16)
        _, amax = pq._launch(wq, pq._pad_rows(xb, n + 1), (None,) * 4,
                             pq.GROUP)
        torch.cuda.synchronize()
        plain = []
        groups = -(-n // pq.GROUP)
        xp = pq._pad_rows(xb, groups * pq.GROUP)
        pq.forward_chain(wq, (None,) * 4, xp.reshape(groups, pq.GROUP, IN_F),
                         plain)
        plain = torch.stack(plain)
        unpadded = []
        pq.forward_chain(wq, (None,) * 4,
                         xb[(groups - 1) * pq.GROUP:][None], unpadded)
        if not float(plain[0, -1]) > float(unpadded[0][0]):
            raise AssertionError("padding rows do not hold the amax here")
        rel = float(((amax - plain).abs() / plain).max())
        log(f"  group amax n={n}: kernel vs plain max rel diff {rel:.2e}, "
            f"last group layer-0 amax {float(amax[0, -1]):.4f} "
            f"(without padding {float(unpadded[0][0]):.4f})")
        if rel > 1e-2:
            raise AssertionError("per-group amax disagrees")
        out = pq.lifting_forward_int8(x=x, prepared=wq)
        ref = pq.lifting_forward_int8_ref(wq, x)
        gate_close(f"lifting_int8_dynamic padded-amax n={n}", out, ref, 2e-3,
                   p99_tol=2e-2)


# ------------------------------------------------------------ phase 4

MODES = (  # (label, --dtype, --quantize, kernel counter)
    ("lifting_bf16", "bfloat16", "", "lifting"),
    ("lifting_f32", "float32", "", "lifting"),
    ("lifting_int8_dynamic", "bfloat16", "int8", "lifting_int8"),
    ("lifting_int8_static", "bfloat16", "int8-static", "lifting_int8"),
)


def plain_normalized(server, x):
    """The served model on normalized rows through the plain versions."""
    import torch
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    eng = server._engine
    x = torch.as_tensor(x, dtype=torch.float32, device=server.device)
    if server._quantize:
        return pq.lifting_forward_int8_ref(eng.prepared, x, eng.static_scales)
    return pl.lifting_forward_ref(eng.prepared, x)


def plain_lift(server, kp):
    """``server.lift`` through the plain versions, on the card."""
    import torch

    kp = torch.as_tensor(kp, dtype=torch.float32, device=server.device)
    x = (kp.reshape(-1, IN_F) - server._mean_part) / server._std_part
    out = plain_normalized(server, x)
    return (out * server._std_s + server._mean_s).reshape(-1, 16, 3)


def drive_slice(work):
    """Serve every mode over HTTP; returns {label: launches} counted over
    the requests alone, and the served and plain MPJPE per mode."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.cli import serve
    from bilinear_tpu_torch.client import PoseClient
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
    from bilinear_tpu_torch.eval.mpjpe import evaluate_mpjpe
    from bilinear_tpu_torch.io.checkpoint import save_checkpoint
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    counters = {"lifting": pl, "lifting_int8": pq}
    data_dir = os.path.join(work, "Human3.6M")
    run_dir = os.path.join(work, "run")
    pdir = os.path.join(run_dir, "parameter")
    write_h36m_dataset(data_dir, n_train=8192, n_valid=4096, seed=SEED)
    save_checkpoint(pdir, 1, random_state_dict(SEED))
    splits = load_h36m(data_dir)
    kp_pool = splits[Task.Train].raw_part.reshape(-1, 16, 2)
    launches, mpjpe = {}, {}
    for label, dtype, quantize, counter in MODES:
        args = serve.build_parser().parse_args([
            "--run-dir", run_dir, "--data-dir", data_dir, "--dtype", dtype,
            "--quantize", quantize, "--port", "0", "--reload-every", "0",
            "--max-delay-ms", "20",
        ])
        http = serve.build_server(args)
        http.warm()
        http.start()
        try:
            client = PoseClient(f"http://{http.host}:{http.port}")
            lifting = http.lifting
            # mean-|d| gates: bf16 and static int8 rows are independent of
            # their batch; dynamic int8 shares each dispatch's amax with the
            # requests it was coalesced with, so it is held to the gate of
            # tests/test_lifting_int8.py::test_server_int8_mode instead.
            tol = 0.05 if quantize == "int8" else 2e-3
            for mod in counters.values():
                mod.LAUNCHES = 0
            answers = []
            for i, n in enumerate(SERVE_ROWS):
                kp = kp_pool[i * 256:i * 256 + n]
                answers.append((kp, client.lift(kp)))
                status = json.loads(client._request(
                    "/v1/lift", json.dumps({"keypoints": kp.tolist()})
                    .encode(), "application/json", method="POST")[0])
                answers.append((kp, np.asarray(status["poses_mm"],
                                               np.float32)))
            results = [None] * 8

            def ask(j):
                kp = kp_pool[1024 + 16 * j:1024 + 16 * (j + 1)]
                results[j] = (kp, client.lift(kp))

            threads = [threading.Thread(target=ask, args=(j,))
                       for j in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            if any(r is None for r in results):
                raise AssertionError("a concurrent request did not answer")
            answers += results
            health = client.health()
            count = {k: m.LAUNCHES for k, m in counters.items()}
            launches[label] = count[counter]
            log(f"  {label}: {health['lift']['batches']} dispatches for "
                f"{health['lift']['rows']} rows; launches {count}")
            if count[counter] == 0:
                raise AssertionError(f"{label}: the kernel was not launched")
            other = [k for k in counters if k != counter]
            if any(count[k] for k in other):
                raise AssertionError(f"{label}: another kernel ran")
            if health["lift"]["batches"] >= len(answers):
                raise AssertionError("concurrent requests were not coalesced")
            for kp, mm in answers:
                ref = plain_lift(lifting, kp)
                gate_close(f"{label} served n={len(kp)}",
                           torch.as_tensor(mm, device="cuda"), ref, tol)

            # hot reload to epoch 2
            kp = kp_pool[:16]
            before = client.lift(kp)
            save_checkpoint(pdir, 2, random_state_dict(SEED + 2))
            if client.reload()["lift_epoch"] != 2 or \
                    client.health()["lift"]["epoch"] != 2:
                raise AssertionError("hot reload did not reach epoch 2")
            after = client.lift(kp)
            if np.allclose(before, after):
                raise AssertionError("answers did not change after reload")
            gate_close(f"{label} after reload",
                       torch.as_tensor(after, device="cuda"),
                       plain_lift(lifting, kp), tol)

            valid = splits[Task.Valid]
            _, served = evaluate_mpjpe(lifting.lift_normalized, valid,
                                       chunk=4096)
            _, plain = evaluate_mpjpe(
                lambda x: plain_normalized(lifting, x), valid, chunk=4096)
            log(f"  {label}: valid MPJPE served {served!r} mm, plain "
                f"{plain!r} mm (random weights, epoch 2)")
            if abs(served - plain) > 0.01 * plain:
                raise AssertionError("served and plain MPJPE disagree")
            mpjpe[label] = (served, plain)
        finally:
            http.stop()
            if os.path.exists(os.path.join(pdir, "2.save")):
                os.remove(os.path.join(pdir, "2.save"))
    return launches, mpjpe


# ------------------------------------------------------------ phase 5


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events, after a warm-up. Weights stay in L2 between calls, as under
    continuous serving."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(kind: str, n: int):
    """Least time (ms) the card could take: the larger of the bytes the
    function must move (rows in and out, weights once) over HBM bandwidth
    and its operations over the peak rate of their type."""
    in_bytes = 4 if kind == "f32" else 2
    rows = n * (IN_F * in_bytes + OUT_F * 4)
    if kind == "int8":
        weights = MACS_HIDDEN + 2 * MACS_ENC_DEC + 4 * (H + 8 * H + OUT_F)
        ops_s = (2 * n * MACS_HIDDEN / PEAK_INT8
                 + 2 * n * MACS_ENC_DEC / PEAK_BF16)
    else:
        weights = in_bytes * (MACS_ENC_DEC + MACS_HIDDEN) + 4 * (5 * H + OUT_F)
        peak = PEAK_F32 if kind == "f32" else PEAK_BF16
        ops_s = 2 * n * (MACS_ENC_DEC + MACS_HIDDEN) / peak
    bytes_s = (rows + weights) / HBM_BYTES_PER_S
    return max(bytes_s, ops_s) * 1e3, ("bytes" if bytes_s > ops_s
                                       else "operations")


def linear_chain(weights, dtype):
    """Yardstick only: the network as six F.linear (cuBLAS) calls."""
    import torch
    import torch.nn.functional as F

    wt = [(w.float().t().contiguous().to(dtype), b.to(dtype))
          for w, b in weights]

    def fn(x):
        h = torch.relu(F.linear(x, *wt[0]))
        for blk in range(2):
            skip = h
            h = torch.relu(F.linear(h, *wt[1 + 2 * blk]))
            h = torch.relu(F.linear(h, *wt[2 + 2 * blk])) + skip
        return F.linear(h, *wt[5])

    return fn


def time_kernels(params, stats, scales):
    import torch
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    w16 = pl.prepare_weights(params, stats, torch.bfloat16, device=dev)
    w32 = pl.prepare_weights(params, stats, torch.float32, device=dev)
    wq = pq.prepare_weights_int8(params, stats, device=dev)
    chain16 = linear_chain(w16, torch.bfloat16)
    chain32 = linear_chain(w32, torch.float32)
    table = {}
    for n in TIME_NS:
        iters = 200 if n <= 4096 else 20
        x = torch.randn((n, IN_F), generator=gen, device=dev)
        x16 = x.to(torch.bfloat16)
        cases = {
            "lifting_bf16": ("bf16", lambda: pl.lifting_forward_cuda(w16, x16),
                             lambda: pl.lifting_forward_ref(w16, x16),
                             lambda: chain16(x16)),
            "lifting_f32": ("f32", lambda: pl.lifting_forward_cuda(w32, x),
                            lambda: pl.lifting_forward_ref(w32, x),
                            lambda: chain32(x)),
            "lifting_int8_dynamic": (
                "int8", lambda: pq.lifting_forward_int8(x=x, prepared=wq),
                lambda: pq.lifting_forward_int8_ref(wq, x),
                lambda: chain16(x16)),
            "lifting_int8_static": (
                "int8",
                lambda: pq.lifting_forward_int8(x=x, prepared=wq,
                                                static_scales=scales),
                lambda: pq.lifting_forward_int8_ref(wq, x, scales),
                lambda: chain16(x16)),
        }
        for name, (kind, kern, plain, chain) in cases.items():
            b_ms, b_by = bound(kind, n)
            # plain, kernel, kernel, plain: the kernel's time is the mean
            # of its two turns, as is the plain version's.
            p1 = cuda_ms(plain, iters)
            k1 = cuda_ms(kern, iters)
            k2 = cuda_ms(kern, iters)
            p2 = cuda_ms(plain, iters)
            c = cuda_ms(chain, iters)
            row = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "cublas_chain_ms": c}
            table.setdefault(name, {})[n] = row
            log(f"  {name} n={n}: kernel {row['ms']:.4f} ms (turns "
                f"{k1:.4f}, {k2:.4f}), plain {row['plain_ms']:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), yardstick cuBLAS "
                f"{'bf16' if kind != 'f32' else 'f32'} 6-linear chain "
                f"{c:.4f} ms")
    return table


# ------------------------------------------------------------------ main

SOURCES = {
    "lifting_bf16": ("bilinear_tpu_torch/csrc/lifting.cu",
                     "bilinear_tpu/ops/pallas/lifting.py:46"),
    "lifting_f32": ("bilinear_tpu_torch/csrc/lifting.cu",
                    "bilinear_tpu/ops/pallas/lifting.py:46"),
    "lifting_int8_dynamic": ("bilinear_tpu_torch/csrc/lifting_int8.cu",
                             "bilinear_tpu/ops/pallas/lifting_int8.py:109"),
    "lifting_int8_static": ("bilinear_tpu_torch/csrc/lifting_int8.cu",
                            "bilinear_tpu/ops/pallas/lifting_int8.py:109"),
}


def run() -> dict:
    import torch

    # phase 1: the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from bilinear_tpu_torch.ops import _build
    from bilinear_tpu_torch.utils.weights import bilinear_to_jax

    # phase 2: build
    secs = _build.build_all(["lifting", "lifting_int8"])
    log(f"phase 2: built csrc/lifting.cu and csrc/lifting_int8.cu in "
        f"{secs:.1f} s")

    # phase 3: kernels vs plain versions
    log("phase 3: kernels vs plain versions")
    params, stats = bilinear_to_jax(random_state_dict(SEED))
    errs, scales = check_kernels(params, stats)

    # phase 4: the slice
    log("phase 4: serving over HTTP")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, _ = drive_slice(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # phase 5: times
    log(f"phase 5: times on {card}")
    table = time_kernels(params, stats, scales)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        at = table[name]
        main, big = at[TIME_NS[0]], at[TIME_NS[1]]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "n": TIME_NS[0],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "yardstick_cublas_chain_ms": main["cublas_chain_ms"],
            f"at_{TIME_NS[1]}": big,
        })
    return {"kernels": kernels, "card": card}


def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device is available; this smoke run needs a GPU")
        return 2
    sys.path.insert(0, ROOT)
    try:
        import bilinear_tpu_torch  # noqa: F401
    except ImportError:
        log("FAIL: bilinear_tpu_torch is not beside chip_smoke.py")
        return 2
    try:
        result = run()
    except Exception:
        traceback.print_exc()
        log("FAIL")
        return 1
    log(result["card"])
    log(json.dumps({"kernels": result["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
