#!/usr/bin/env python3
"""K5's design space on the card: csrc/int8_scale_probe.cu rebuilt with other
cluster sizes and ring depths, each held to the repo build's output and
timed.

    python3 scripts/torch_k5_sweep.py [CL,STAGES ...] [--clocks]

Each CL,STAGES pair (default: 2,6 (the repo's), 4,6, 2,5, 2,4) is a copy of
the source with those two constants, built by nvcc into a temporary
directory (removed at the end). Its fixed and mxu outputs must be the repo
build's bits at n = 1, 255, 4096 and 65536 (bf16 rows from a seed); then
both variants of every build are timed at n = 256 and 65536 by CUDA events
(chip_smoke.cuda_ms), two rounds in turn. --clocks adds a build of the
repo's constants with clock64 reads at the consumers' call sites and prints
each phase's mean SM clocks per warpgroup and call: waiting for stages, the
passes' products (their waits included), epilogues, decodes, layer
barriers, encode passes, the order barrier and the whole kernel (the reads
slow the kernel; compare phases, not totals). One JSON line per result,
each with the card's name and power limit. Needs a CUDA device; imports
nothing of JAX.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# The instrumented build: (call site in the source, the same with its time
# added to T[i]). Each must be found once or more, or the script stops.
PHASES = ["wait_full", "products", "finish", "decode", "layer_done",
          "encode", "total", "order_wait"]


def _timed(call: str, i: int) -> str:
    return f"{{ long long _t = clock64(); {call} T[{i}] += clock64() - _t; }}"


CLOCK_SITES = [
    ("namespace probe {\n",
     "namespace probe {\n__device__ long long k5_clocks[264 * 8];\n"),
    ("  __device__ __forceinline__ unsigned char* wait_full() {\n"
     "    bar_wait(full0 + 8 * stage, phase);",
     "  long long T[8] = {};\n"
     "  __device__ __forceinline__ unsigned char* wait_full() {\n    "
     + _timed("bar_wait(full0 + 8 * stage, phase);", 0)),
    ("      products(in, acc);\n",
     "      " + _timed("products(in, acc);", 1) + "\n"),
    ("        finish<L>(p, m0, acc, o, out, y);\n",
     "        " + _timed("finish<L>(p, m0, acc, o, out, y);", 2) + "\n"),
    ("        decode(p, y, st, dec);\n",
     "        " + _timed("decode(p, y, st, dec);", 3) + "\n"),
    ("      layer_done();", "      " + _timed("layer_done();", 4)),
    ("          encode(p, m0);\n", "          " + _timed("encode(p, m0);", 5)
     + "\n"),
    ("      begin_pass();\n", "      " + _timed("begin_pass();", 7) + "\n"),
    ("  __device__ void run(int cid, int clusters, uint32_t rank) {\n",
     "  __device__ void run(int cid, int clusters, uint32_t rank) {\n"
     "    const long long _t0 = clock64();\n"),
    ("      } else if (next < a.tiles) {\n        store_x(xv);\n      }\n"
     "    }\n",
     "      } else if (next < a.tiles) {\n        store_x(xv);\n      }\n"
     "    }\n    T[6] = clock64() - _t0;\n    if (t == 0)\n"
     "      for (int i = 0; i < 8; ++i)\n"
     "        k5_clocks[(blockIdx.x * 2 + c) * 8 + i] = T[i];\n"),
]


def variant_source(src: str, cl: int, stages: int, clocks: bool) -> str:
    src = re.sub(r"constexpr int CL = \d+;", f"constexpr int CL = {cl};", src)
    src = re.sub(r"constexpr int STAGES = \d+;",
                 f"constexpr int STAGES = {stages};", src)
    if clocks:
        for site, timed in CLOCK_SITES:
            if site not in src:
                raise RuntimeError(f"no call site {site!r} in the source")
            src = src.replace(site, timed)
        src += ('\nextern "C" int k5_clocks_read(long long* h) {\n'
                "  return (int)cudaMemcpyFromSymbol(h, probe::k5_clocks,\n"
                "                                   sizeof(probe::k5_clocks));"
                "\n}\n")
    return src


def main() -> int:
    sys.path.insert(0, os.path.abspath(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; the sweep times the card's kernels")
        return 2
    import chip_smoke as cs
    from bilinear_tpu_torch.ops import _build
    from bilinear_tpu_torch.ops import int8_scale_probe as kp
    from bilinear_tpu_torch.ops import lifting_int8 as pq
    from bilinear_tpu_torch.utils.weights import bilinear_to_jax

    args = [a for a in sys.argv[1:] if a != "--clocks"]
    builds = [tuple(int(v) for v in a.split(",")) + (False,) for a in args] \
        or [(2, 6, False), (4, 6, False), (2, 5, False), (2, 4, False)]
    if "--clocks" in sys.argv:
        builds.append((kp.CLUSTER, kp.STAGES, True))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["int8_scale_probe"])
    with open(os.path.join(_build.CSRC, "int8_scale_probe.cu")) as f:
        src = f.read()
    work = tempfile.mkdtemp(prefix="k5_sweep_")
    try:
        procs = {}
        for cl, stages, clocks in builds:
            d = os.path.join(work, f"cl{cl}_s{stages}{'_clocks' if clocks else ''}")
            os.makedirs(d)
            for h in ("lifting_common.cuh", "wgmma_sm90.cuh"):
                shutil.copy(os.path.join(_build.CSRC, h), d)
            with open(os.path.join(d, "k.cu"), "w") as f:
                f.write(variant_source(src, cl, stages, clocks))
            procs[cl, stages, clocks] = (d, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                 os.path.join(d, "k.so"), os.path.join(d, "k.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs = {}
        for key, (d, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {key}:\n{log}")
            lib = ctypes.CDLL(os.path.join(d, "k.so"))
            fn = lib.int8_scale_probe_forward
            fn.argtypes, fn.restype = kp._ARGTYPES, ctypes.c_int
            cap = lib.int8_scale_probe_clusters
            cap.argtypes = [ctypes.POINTER(ctypes.c_int)]
            cap.restype = ctypes.c_int
            got = ctypes.c_int(0)
            _build.check(cap(ctypes.byref(got)), "int8_scale_probe_clusters")
            libs[key] = (lib, fn, got.value)

        params, stats = bilinear_to_jax(cs.random_state_dict(cs.SEED))
        wq = pq.prepare_weights_int8(params, stats, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
        x_all = torch.randn((65536, cs.IN_F), generator=gen,
                            device="cuda").to(torch.bfloat16)
        image = kp._image(wq)
        w = pq._weight_pointers(wq, x_all.device)

        def call(key, x, variant):
            _, fn, capacity = libs[key]
            cl, n = key[0], x.shape[0]
            clusters = min(capacity, -(-n // (cl * 64)))
            out = torch.empty((n, cs.OUT_F), device="cuda")
            skip = (torch.empty((clusters * cl, 64, 1024), device="cuda")
                    if variant == "fixed" else None)
            rc = fn(x.data_ptr(), image.data_ptr(), w[1],
                    *[w[i] for i in (3, 4, 6, 7, 9, 10, 12, 13)], w[15],
                    out.data_ptr(), None if skip is None else skip.data_ptr(),
                    None, None, None, None, None, kp.FIXED_SCALE,
                    kp.INV_FIXED_SCALE, 0 if variant == "fixed" else 1, n,
                    clusters, torch.cuda.current_stream().cuda_stream)
            _build.check(rc, "int8_scale_probe_forward")
            return out

        for n in cs.PROBE_ROWS:
            for variant in ("mxu", "fixed"):
                want = kp.probe_forward(wq, x_all[:n], variant)
                for key in libs:
                    got = call(key, x_all[:n], variant)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"build {key} {variant} n={n}: "
                                             f"not the repo build's bits")
        for key in libs:
            if not key[2]:
                continue
            lib = libs[key][0]
            for n in cs.TIME_NS:
                for variant in ("mxu", "fixed"):
                    call(key, x_all[:n], variant)
                    torch.cuda.synchronize()
                    buf = (ctypes.c_longlong * (264 * 8))()
                    _build.check(lib.k5_clocks_read(buf), "k5_clocks_read")
                    grid = min(libs[key][2], -(-n // (key[0] * 64))) * key[0]
                    arr = np.array(buf[:]).reshape(132, 2, 8)[:grid]
                    print(json.dumps({
                        "clocks": variant, "n": n, "cluster": key[0],
                        "stages": key[1], "card": card,
                        **{p: float(arr[:, :, i].mean())
                           for i, p in enumerate(PHASES)}}), flush=True)
        for n in cs.TIME_NS:
            iters = 100 if n <= 4096 else 20
            for variant in ("mxu", "fixed"):
                turns = {key: [] for key in libs if not key[2]}
                for _ in range(2):
                    for key in turns:
                        turns[key].append(cs.cuda_ms(
                            lambda: call(key, x_all[:n], variant), iters))
                for key, ms in turns.items():
                    print(json.dumps({
                        "variant": variant, "n": n, "cluster": key[0],
                        "stages": key[1], "ms": sum(ms) / len(ms),
                        "turns_ms": ms, "clusters_on_card": libs[key][2],
                        "card": card}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
