#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bilinear_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is swallowed):
1. Card: name and power limit from nvidia-smi; TF32 switched off for
   matmuls and cuDNN, so the plain f32 versions run in full f32.
2. Build: every CUDA source (csrc/lifting.cu, csrc/lifting_int8.cu,
   csrc/resmodule.cu, csrc/int8_conv.cu, csrc/int8_scale_probe.cu,
   csrc/conv_epilogue.cu), one nvcc each, in parallel.
3. Kernels vs their plain PyTorch versions, on the card, in the working
   type: K1 bf16 and f32, K2 dynamic and static, at every n of row_counts()
   (both sides of every boundary between kernel paths and tiles), full-width
   weights with scrambled BN statistics from a seeded torch.Generator; K1's
   rows must be the same bits whatever batch and route they came through
   (one launch, the per-layer GEMM, the persistent kernel up to 65573 rows),
   K2's quantisation the plain version's bit for bit, its two kernel paths
   the same bits on the same rows, and dynamic mode's quantise-pass route
   (one scale group of more rows than the card holds tiles for) is held
   against the plain version with its launches counted.
   3b. K3 train (output, the six batch statistics and the running
   statistics it updates in place), K3 eval and K4 (g_x and every parameter
   gradient) against res_block_ref / res_block_bwd_ref at every ResModule
   shape of the full-width detector, tail batches and a served End2End
   batch of one frame (N = 16 at 4x4, and its 64x64 modules), in bf16 and
   f32; and
   K3 eval and K3 train with running=None under no_grad at three batch-16
   shapes of the evaluation slice (the BN buffers bit-unchanged).
   3c. K5, the int8 scale probe's chains (ops/int8_scale_probe.py), at n =
   1, 255, 4096 and 65536: on dyadic inputs (every sum exact in f32) the
   mxu chain equal to its plain version bit for bit (output and every
   activation) and the fixed chain's int8 activations equal to its plain
   version's, its output within K2 static's gates; on seeded random
   inputs fixed within K2 static's gates, and mxu from its own first int8
   activation on bit for bit (rows whose first activation differs from
   the plain version's are counted, not gated: the encode sums in another
   order); every K5 call one launch, its output the same bits without the
   activation copies. Then the probe's seven rows
   (scripts/torch_int8_scale_probe.py: dynamic K2 at 256-, 512- and
   1024-row groups, fixed, mxu-bound, lifting_forward_int8 dynamic and
   static) at n = 256 and 65536 by CUDA events beside the bound, the plain
   version and K2 static, with K5's launches counted; then K5 by a profiler
   trace at both n: one device kernel a call.
   3d. K8, the conv epilogue (ops/conv_epilogue.py), against its plain
   version at HRNet-W48's served epilogues (batch 128: the branches'
   BasicBlock sums at 48x64..384x8, exchange rows with up- and
   down-sampled terms, the stem, a Bottleneck's downsample, the f32 head)
   and ViTPose-H's (its head's two BN + ReLU at 256 x 32 x 24 and 256 x 64
   x 48, and the f32 head at 16 x 64 x 48: sides that are no powers of
   two) in bf16 and f32, one launch a call; a planted fault (a term read at
   the wrong resolution step) must be caught; 262 launches in one served
   128-frame HRNet chunk and 3 in one served 128-frame ViTPose-H chunk;
   then its times at a BasicBlock's (128, 48, 64, 64) and exchange row 0
   of stage 4 beside its bound (bytes), its plain version and the
   wrapper's host time (``phase3d_alone()`` runs phases 1, 2 and 3d
   alone).
4. The lifting slice: a synthetic H36M dataset and an epoch-1 checkpoint
   written by the port; for each serving mode the daemon of cli/serve.py
   answers /v1/lift requests (JSON and .npy, concurrent ones coalesced)
   through PoseHTTPServer, each answer is checked against the plain path,
   the kernel's launch counter must rise, epoch 2 hot-reloads through
   /admin/reload, and the valid-split MPJPE of the served and plain paths
   is printed.
5. Lifting times with CUDA events after warm-up at n = 256 (the daemon's
   max_rows) and n = 65536, beside each kernel's bound, its plain version
   and, as a labelled yardstick, the cuBLAS chain of six F.linear calls;
   from a torch.profiler trace the device kernels per call (asserted: one
   launch for a serving batch, six per bulk call, plus dynamic mode's
   memset, the bf16 and int8 products in this repo's wgmma kernels) and the microseconds per kernel of a bulk call; K1's route
   counter (asserted: every bf16 call at n = 65536 through the persistent
   kernel, a serving batch through the one-launch kernel); K1 bf16 through
   its per-layer GEMM and its persistent kernel at 1025, 2048, 2049, 4097
   and 65536 rows (trace and events); both kernel
   paths around the boundary between them; the host's time per call on the
   wrappers' weight checks; poses/s of LiftingServer end to
   end at n = 65536 and the wall latency of /v1/lift at 1, 16 and 256 rows
   (measurements, no gate).
6. The detector slice: a synthetic MPII tree written by the port, then
   cli.train_hourglass.main at full width (8 stacks, 256 features, depth
   4, batch 8) in bf16 with --fused-blocks true, twice: the second run
   must resume from epoch 1 and write 2.save. K3-train and K4 must launch
   exactly 107 times per step and K3-eval 107 times per overlay forward;
   the loss must be finite.
7. Full-width step parity: loss and per-tensor gradients of
   MainModel(fused=True) against MainModel(fused=False) (cuDNN + torch BN)
   from one state on one batch, f32 and bf16; and each
   f32 path's gradients against the standard model's in float64
   (reported: which path owns the f32 gap).
8. Detector times: K3 train, K3 eval and K4 in bf16 at the eight
   full-width shapes of a training step, by CUDA events and as the sum of
   kernel durations in a torch.profiler trace, with the device kernels per
   call (at most 8, 4 and 18, wrapper included), the launches per step and
   the bound; at (8, 64, 64, 256 -> 256) and (8, 128, 128, 64 -> 128) also
   the plain version and the standard ResModule as a labelled yardstick;
   and one full training step, fused and standard, as ms/step, img/s,
   device time and kernels per step, and the host's time per phase.
9. The lifting training slice: a synthetic H36M tree written by the port
   (200 steps of 64 rows and a tail step per epoch), cli.train_bilinear at
   full width in bf16 for 2 epochs and then 1 more that must resume from
   2.save (finite losses; Adam's count and the step counter those of 3
   epochs of n // 64 + 1 steps), cli.valid_bilinear, and the checkpoint
   served through LiftingServer (K1 bf16 and f32, launches counted): its
   valid MPJPE within 1% (bf16) and 0.1% (f32) of the CLI's. Then
   BilinearTrainer's ms/step and poses/s over 1000 steps, f32 and bf16,
   with device-busy ms and device kernels per step from a trace.
10. The detector evaluation slice, on phase 6's tree and 2.save:
   cli.valid_hourglass in f32 with --fused-blocks true and false (per-joint
   PCKh hits within one; exactly 107 K3-train launches per recalibration
   batch and 107 K3-eval launches per flip-TTA forward of 16, none without
   the fused blocks), cli.eval_hourglass twice (-1.save written once and
   reused; one .txt per test rect; the converter's count), the fused
   model's recalibrated statistics and batch-16 heatmaps against the
   standard model's (f32), and img/s of the recalibration forward and the
   PCKh step in bf16, fused and standard, with device-busy ms and kernels
   per call. Each CLI of phases 10 and 11 starts from torch's default
   precision switches (cuDNN in TF32) and must turn TF32 off itself.
11. The fine-tuning and SH slice, on a synthetic H36M tree with images (24
   train, 8 valid frames): cli.train_hourglass_ft at full width in f32 for
   one epoch and once more (resume, 2.save, finite losses, the step
   counters those of 2 x 3 steps), cli.valid_hourglass_ft
   (pckh_ft_epoch2.json, finite), cli.sh_preprocess --variant preact
   --protocol-out SH+FT (both bins, every key but part the GT bins'),
   cli.sh_preprocess --variant torch7 on phase 6's 2.save with
   --fused-blocks true (exactly 107 K3-eval launches per export forward)
   and false (none; the detections of the two agree), cli.train_bilinear
   --protocol SH+FT and cli.valid_bilinear (a finite MPJPE); the preact
   model's f32 heatmaps and gradients against float64 on the card (median
   gated); that an FT step's forward reads nothing from the card on the
   host; and times of the FT step, the recalibration forward and the SH
   export forwards.
12. The End2End slice, on phase 11's H36M tree: cli.train_end2end
   --variant torch7 --fused-blocks true at full width in f32,
   warm-started from phase 6's torch7 2.save and phase 9's lifting
   checkpoint, then resumed (finite losses; exactly 107 K3-train and 107 K4
   launches per step, none of K3-eval, K1 or K2); cli.valid_end2end fused
   (107 K3-eval launches per batch) and standard (none), MPJPE within
   0.1%, and its error on a run with no checkpoint; cli.webcam --synthetic
   (4 PNGs, 107 launches per frame); a daemon of End2EndServer (fused,
   bf16) beside a LiftingServer: hot reload of epoch 2 and /v1/lift
   through K1, then /v1/pose requests of 1-21 u8, f32 and mixed person
   frames of the H36M tree through 2.save (against predict, the plain f32
   path and u8 = f32 / 255; 107 K3-eval launches per chunk; a planted K3
   fault must fail the same gate); fused vs standard f32 step parity, with
   float64 beside both and beside the standard model on core/norm.py's BN;
   and times of the train step, predict and /v1/pose.
13. The detectors' int8 convolutions (kernels K6, K7): the distinct conv
   shapes of a full-width torch7 and preact int8 forward (INT8_SHAPES; 321
   / 345 K6 and K7 launches per forward, no K3), and K6 and every K7 route
   against their plain versions bit for bit (int8 values, scales, int32
   accumulators, outputs) at each shape at batch 1, 8 and 16, bf16 and
   f32, and at three extra shapes: K7 through its own plan and, at batch 8
   in bf16, through every other route and tile forced through plan_conv,
   and the one-call K6 + K7 entry; two planted faults must be caught (K7
   given the scales of the wrong sample; a split-K plan with its last
   split dropped); cli.serve --kind both --quantize int8 on phase 12's
   End2End 2.save: /v1/pose at 1, 8, 16 frames equal to predict, 321 K6
   and K7 launches per chunk and no K3, /v1/lift through K2; the int8
   model on the tree's frames equal to its plain int8 version (the planted
   wrong-scale fault must fail that), within JAX's int8-versus-float
   heatmap gates of the bf16 model and no farther from the plain f32 model
   than 1.5x the bf16 model in decode shift, pose2d and mm (JAX's absolute
   decode gates reported); times: K7 and K6 per shape by events and by
   trace beside their bounds, cuDNN's bf16 conv (events and trace) and
   torch._int_mm over an im2col, the plain versions, int8 against bf16
   predict with each chunk's device time and K6/K7 share by trace,
   /v1/pose p50 of both.
14. AOT export: cli.export_aot of lifting (symbolic bf16 and int8-static)
   from phase 9's checkpoint and of End2End (batch 8) from phase 12's
   2.save; each artifact loaded in a fresh process that imports io/aot.py
   alone, its answers (chunked and padded) against the in-process plain
   path; a serve --aot daemon answering /v1/lift and /v1/pose as the
   artifacts do; export, load and /v1/pose times.

15. Camera and bin generation, then parallelism: project on the card
   against project_np over 2^20 poses of 17 joints per camera and the
   unproject round trip; GT bins of manifold poses through the camera,
   cli.train_bilinear at full width for 10 epochs (valid MPJPE below 0.1x
   epoch 0's), the learnable image tree (markers at the projected joints)
   and the trained run served through LiftingServer (K1); train_bilinear
   DP (2 ranks), TP (1 x 2) and DP x TP (2 x 2) and a full-width standard
   train_hourglass DP step (2 x 4 rows), every rank a process started
   through the CLI's --coordinator flags on this card (gloo), each against
   one process, side by side; DP and TP step times, each alone; a one-rank
   NCCL run (--fused-blocks true over 2 ranks is
   phase 16's run); LiftingServer(mesh=["cuda:0"] * 2) in bf16, int8 and int8-static
   and End2EndServer(mesh=...) fused bf16 and int8 against the unsharded
   servers (launches per call, bit-equality per shard); pipeline_forward
   fused and int8 at (S, M) in {(2, 2), (4, 4), (8, 8)} with its
   launches, pipeline_end2end against End2End, one make_pp_train_step at
   (2, 2) against the accumulated one-process step; times of each.
16. Fused blocks under data parallelism, remat, --debug-nans, preemption,
   --profile, the canvas cache, doctor: the staged K3/K4 (four stage
   entries per call, each BN reduction merged over the ranks between them)
   against the unstaged call bit for bit with one rank and against the
   plain versions with two ranks as threads (a skipped exchange must fail
   that gate); cli.train_hourglass --fused-blocks true at full width over
   2 ranks sharing the card (gloo), f32 (timed alone) and bf16 (side by
   side with the untimed legs), against one process at phase 15's gates
   (bf16 at phase 7's yardstick), 107 K3-train and K4 launches per step
   per rank, each of four stage entries, step ms; a one-rank NCCL run;
   every staged call
   with its first exchange skipped must fail the gate; a fused End2End
   step over 2 ranks against one process; HourglassTrainer(remat=True) at
   batch 8, fused bf16 (bit for bit) and standard f32 (within two plain
   steps' spread) against a plain step, peak memory lower, K3 launched
   twice per block; --debug-nans (2 of 8 stacks): a clean step passes and
   an inf planted in a fused block's weight stops the run naming the
   block; SIGTERM in
   epoch 1 of a train_hourglass process (exit 0, 1.save, resumed to
   2.save) and to rank 1 of 2 (both stop after epoch 1); train_bilinear
   --profile true (a trace with CUDA kernels); the canvas cache on phase
   6's tree (run before that tree is removed: cached batches equal
   uncached ones bit for bit, no JPEG decoded in epoch 2, the CLI's
   --cache-canvases); cli.doctor (exit 0, every probe, its matmul and
   transfer figures).
17. Spatial sharding of the detectors' eval forward (parallel/spatial.py)
   over ["cuda:0"] * S, S = 2 and 4: K3 eval on each haloed slab
   (cropped) bit for bit against K3 on the whole tensor at the stem
   block, a 64x64 block and the waist's one-row slabs, bf16 and f32; K6's
   stage entries (each slab's amax, the maximum over slabs, quantisation
   with that scale) against the one-launch K6 and their plain versions;
   K7 on each haloed int8 slab against K6 + K7 on the whole tensor (a
   planted fault, slabs quantised with their own amax, must break it);
   then phase 6's torch7 2.save as standard f32, fused bf16 and int8 and a
   seeded full-width preact detector, standard f32 and int8, on 256x256
   frames at batch 1 and 8 against their unsharded forwards (f32 within
   1e-5 of the largest heatmap; bf16 and int8 no farther from the
   unsharded f32 model than 1.5x the unsharded bf16 / int8 model), with
   107 S K3-eval and 321 S (345 S) K7 launches per forward, K6's stage
   entries twice that, no one-launch K6, halo exchanges and bytes; a
   skipped halo exchange must fail the f32 gate; ms per forward at S = 1,
   2, 4 and one S = 2 fused forward by trace. The slabs share one card:
   no scaling figure.

Phases run in the order 1-3, 3b, 3c, 3d, 4, 5, 9, 6-8, 10-14, 16g, 17, 15, 16. The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or bilinear_tpu.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

def row_counts():
    """Row counts of phase 3: a single row, ragged counts, the daemon's
    max_rows, whole and partial 512-row groups, both sides of the boundary
    between the one-launch and the per-layer path (of the rows and of
    dynamic mode's rows + 1), of the one between K1's per-layer GEMM and its
    persistent kernel and of the f32 kernel's tile changes (512, 4096), the
    bulk size, and a bulk count whose last 128 x 256 tile is ragged."""
    from bilinear_tpu_torch.ops.lifting import FUSED_MAX_ROWS as top
    from bilinear_tpu_torch.ops.lifting import PERSISTENT_MIN_ROWS as bulk

    return tuple(sorted({1, 100, 256, 512, 513, 700, top - 1, top, top + 1,
                         bulk - 1, bulk, 4096, 4097, 65536, 65573}))


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


def gate_close(name, out, ref, mean_tol, max_tol=None, p99_tol=None,
               scale_of=None):
    """Mean |diff| (and max or 99th percentile) relative to mean |ref|, or
    to mean |scale_of| when given."""
    import torch

    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    d = (out - ref).abs()
    scale = float((ref if scale_of is None else scale_of.float()).abs()
                  .mean()) or 1.0
    mean, mx = float(d.mean()), float(d.max())
    msg = (f"{name}: max|d| {mx:.3e} mean|d| {mean:.3e} (mean|"
           f"{'ref' if scale_of is None else 'db3'}| {scale:.3e})")
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
    ns = row_counts()
    log(f"  row counts {ns}; K1 bf16 routes " + ", ".join(
        f"{n}: {pl.choose_route(n, torch.bfloat16)}" for n in ns))
    x_all = torch.randn((max(ns), IN_F), generator=gen, device=dev)
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
        for n in sorted(ns, reverse=True):
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
    for n in ns:
        x = x_all[:n]
        out = pq.lifting_forward_int8(x=x, prepared=wq)
        torch.cuda.synchronize()
        ref = pq.lifting_forward_int8_ref(wq, x)
        mx, _ = gate_close(f"lifting_int8_dynamic n={n}", out, ref, 2e-3,
                           p99_tol=2e-2)
        err = max(err, mx)
    errs["lifting_int8_dynamic"] = err
    check_group_amax(params, stats, x_all)
    check_quantize()

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
    for n in ns:
        x = x_all[:n]
        out = pq.lifting_forward_int8(x=x, prepared=wq, static_scales=scales)
        torch.cuda.synchronize()
        ref = pq.lifting_forward_int8_ref(wq, x, scales)
        mx, _ = gate_close(f"lifting_int8_static n={n}", out, ref, 2e-3,
                           p99_tol=2e-2)
        err = max(err, mx)
    errs["lifting_int8_static"] = err
    check_int8_routes(wq, scales, x_all)
    return errs, scales


def check_int8_routes(wq, scales, x_all):
    """K2's routes against each other and the plain version. (a) The
    one-launch and the per-layer path on the same rows, both modes: the same
    bits (integer products, exact amax, one epilogue). (b) Dynamic mode's
    quantise-pass route, taken when one scale group holds more rows than
    the card holds tiles for at once: twice the card's capacity as ONE
    group, as calibrate_scales runs a large calibration batch; amax, output
    and the calibrated scales against the plain version, and the same call
    in 512-row groups (no pass) for the device launches of each."""
    import torch
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    for n in (100, 513, pl.FUSED_MAX_ROWS):
        xb = x_all[:n].to(torch.bfloat16)
        for mode, rows, sc, gr in (
                ("dynamic", pq._pad_rows(xb, n + 1) if n % pq.GROUP else xb,
                 (None,) * 4, pq.GROUP),
                ("static", xb, tuple(scales), pq._ONE_GROUP)):
            a, b = (pq._launch(wq, rows, sc, gr, path=path)[0]
                    for path in ("fused", "layers"))
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"lifting_int8_{mode} n={n}: the two "
                                     f"kernel paths give different bits")
    log("  K2: one-launch and per-layer path bit-equal at n = 100, 513, "
        f"{pl.FUSED_MAX_ROWS}, both modes")

    cap = pq.group_capacity(torch.device("cuda"))
    n = 2 * cap
    if n > x_all.shape[0] or not pq.needs_quantize_pass(n, pq._ONE_GROUP, cap):
        raise AssertionError(f"no quantise-pass case at capacity {cap}")
    x = x_all[:n]
    xb = x.to(torch.bfloat16)
    out, amax = pq._launch(wq, xb, (None,) * 4, pq._ONE_GROUP)
    torch.cuda.synchronize()
    plain = []
    ref = pq.forward_chain(wq, (None,) * 4, xb[None], plain)[0]
    plain = torch.stack(plain)
    rel = float(((amax - plain).abs() / plain).max())
    log(f"  K2 dynamic, {n} rows as one group (capacity {cap} rows: a "
        f"quantise pass per hidden layer): amax vs plain max rel diff "
        f"{rel:.2e}")
    if rel > 1e-2:
        raise AssertionError("one-group amax disagrees")
    gate_close(f"lifting_int8_dynamic one group n={n}", out, ref, 2e-3,
               p99_tol=2e-2)
    got = pq.calibrate_scales(wq, x)
    want = tuple(pq._round_sig(max(float(a), 1e-12) / 127.0)
                 for a in plain[:, 0])
    log(f"  calibrate_scales on {n} rows: kernel {got} plain {want}")
    for a, b in zip(got, want):
        if abs(a - b) > 1.01 * _unit3(max(a, b)):
            raise AssertionError("calibrated scales disagree")
    for gr, with_pass in ((pq._ONE_GROUP, True), (pq.GROUP, False)):
        fn = lambda: pq._launch(wq, xb, (None,) * 4, gr)  # noqa: E731
        fn()
        per = _trace_whole(fn, 3)
        launches = round(sum(cnt for _, cnt in per.values()))
        log(f"  K2 dynamic n={n}, groups of {min(gr, n)}: {launches} device "
            f"launches per call, "
            f"{sum(ms for ms, _ in per.values()):.4f} ms by trace")
        if launches != pq.dynamic_launches(n, with_pass):
            raise AssertionError(
                f"{launches} launches, expected "
                f"{pq.dynamic_launches(n, with_pass)}: {list(per)}")


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


def check_quantize():
    """The kernel's quantisation (an FMA sequence that stands for the true
    division) against the plain ``quantize_activation`` on the card, bit for
    bit: 4096 rows of ReLU-like values (half of them zeros), values on and
    one ulp off the half-integer boundaries (k + 0.5) s, and values of every
    size down to the subnormals, in 512-row groups with their own scales."""
    import torch
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    m = 4096
    h = torch.relu(torch.randn((m, H), generator=gen, device=dev)) * 3.0
    amax = h.reshape(-1, pq.GROUP, H).amax(dim=(1, 2))
    # tensor / tensor: torch turns a division by a Python scalar on the card
    # into a product with its reciprocal, which is not the true quotient.
    s = (torch.clamp_min(amax, 1e-12) / torch.full_like(amax, 127.0)) \
        .repeat_interleave(pq.GROUP)
    k = torch.randint(0, 127, (m, 64), generator=gen, device=dev).float()
    edge = (k + 0.5) * s[:, None]
    h[:, 0:64] = edge
    h[:, 64:128] = torch.nextafter(edge, torch.zeros_like(edge))
    h[:, 128:192] = torch.nextafter(edge, torch.full_like(edge, 1e9))
    h[:, 192:256] = torch.exp2(torch.linspace(-149, 6, 64, device=dev))
    q = pq.quantize_rows_cuda(h, amax, pq.GROUP)
    torch.cuda.synchronize()
    ref = pq.quantize_activation(h, s[:, None]).to(torch.int8)
    bad = int((q != ref).sum())
    log(f"  quantise pass vs plain true division: {bad} of {q.numel()} "
        f"values differ")
    if bad:
        raise AssertionError("the kernel's quantisation is not the plain "
                             "version's")


# ------------------------------------------------------------ phase 3c

PROBE_ROWS = (1, 255, 4096, 65536)
PROBE_BATCH = 65536  # the probe's BATCH
PROBE_GROUPS = (256, 512, 1024)


def dyadic_probe_inputs(wq, n, gen):
    """K5's exact inputs: ``wq`` (prepared on the card) with its encode and
    decode replaced by dyadic values (weights j/16, biases i/8, |i|, |j| <=
    16) and its hidden weights by random int8, and n rows of k/4 (|k| <=
    16). Every encode sum then has at most 14 significant bits and every
    mxu decode sum at most 22: exact in f32 in any order. Rows 0 and 1
    drive channels 0 and 1 to +-130, past int8's range. On ``gen``'s
    device."""
    import torch
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    dev = gen.device

    def ints(shape, hi=16):
        return torch.randint(-hi, hi + 1, shape, generator=gen,
                             device=dev).float()

    enc_w, enc_b = ints((IN_F, H)) / 16, ints((H,)) / 8
    dec_w, dec_b = ints((H, OUT_F)) / 16, ints((OUT_F,)) / 8
    enc_w[:, 0], enc_w[:, 1], enc_b[0], enc_b[1] = 1.0, -1.0, 2.0, -2.0
    x = ints((n, IN_F)) / 4
    x[0], x[1] = 4.0, -4.0
    prepared = pq.PreparedInt8({
        "encode": (enc_w.to(torch.bfloat16), enc_b),
        "hidden": [(ints((H, H), 127).to(torch.int8), ws, b)
                   for _, ws, b in wq["hidden"]],
        "decode": (dec_w.to(torch.bfloat16), dec_b)})
    prepared["kmajor"] = [w.t().contiguous() for w in (
        prepared["encode"][0], *(h[0] for h in prepared["hidden"]),
        prepared["decode"][0])]
    return prepared, x


def _activations_equal(name, got, want):
    """The kernel's activations (``probe_forward``'s) against the plain
    version's list, bit for bit: each hidden layer's int8 input and, when
    the list holds it, the decode's int8 input (bf16 in the kernel)."""
    import torch

    kernel = list(got["q"]) + [got["decode_input"]]
    for i, w in enumerate(want):
        if not torch.equal(kernel[i].float(), w.float()):
            bad = int((kernel[i].float() != w.float()).sum())
            raise AssertionError(f"{name}: activation {i} differs from the "
                                 f"plain version's in {bad} values")


def _copies_change_nothing(prepared, x, variant, out):
    """K5 ``variant`` on rows ``x`` without its activation copies: the
    output ``out`` of the call with them, bit for bit, in one launch."""
    import torch
    from bilinear_tpu_torch.ops import int8_scale_probe as kp

    before = kp.LAUNCHES[variant]
    bare = kp.probe_forward(prepared, x, variant)
    torch.cuda.synchronize()
    if kp.LAUNCHES[variant] != before + 1:
        raise AssertionError(f"K5 {variant}: {kp.LAUNCHES[variant] - before} "
                             f"launches in one call")
    if not torch.equal(bare, out):
        raise AssertionError(f"K5 {variant} n={x.shape[0]}: the output "
                             f"without the activation copies differs in "
                             f"{int((bare != out).sum())} values")


def check_probe(params, stats):
    """Phase 3c's checks of K5. Returns {kernel: max_abs_err}."""
    import torch
    from bilinear_tpu_torch.ops import int8_scale_probe as kp
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    wq = pq.prepare_weights_int8(params, stats, device=dev)
    errs = {"int8_scale_probe_fixed": 0.0, "int8_scale_probe_mxu": 0.0}

    exact, x_all = dyadic_probe_inputs(wq, max(PROBE_ROWS), gen)
    span = (0, 0)
    for n in PROBE_ROWS:
        x = x_all[:n]
        out, acts = kp.probe_forward(exact, x, "mxu", activations=True)
        torch.cuda.synchronize()
        want = []
        ref = kp.mxu_chain_ref(exact, x, want)
        _activations_equal(f"K5 mxu dyadic n={n}", acts, want)
        span = (int(acts["q"][0].min()), int(acts["q"][0].max()))
        if not torch.equal(out, ref):
            raise AssertionError(f"K5 mxu dyadic n={n}: output differs from "
                                 f"the plain version's in "
                                 f"{int((out != ref).sum())} values")
        _copies_change_nothing(exact, x, "mxu", out)
        out, acts = kp.probe_forward(exact, x, "fixed", activations=True)
        torch.cuda.synchronize()
        _copies_change_nothing(exact, x, "fixed", out)
        want = []
        ref = kp.fixed_chain_ref(exact, x, want)
        _activations_equal(f"K5 fixed dyadic n={n}", acts, want)
        mx, _ = gate_close(f"int8_scale_probe_fixed dyadic n={n}", out, ref,
                           2e-3, p99_tol=2e-2)
        errs["int8_scale_probe_fixed"] = max(errs["int8_scale_probe_fixed"],
                                             mx)
    log(f"  K5 on dyadic inputs at n = {PROBE_ROWS}: mxu bit-equal "
        f"(output and all five int8 activations), fixed's four int8 "
        f"activations bit-equal; first mxu activation spans {list(span)}; "
        f"both outputs the same bits without the activation copies, one "
        f"launch a call")

    x_all = torch.randn((max(PROBE_ROWS), IN_F), generator=gen, device=dev)
    for n in PROBE_ROWS:
        x = x_all[:n]
        out, acts = kp.probe_forward(wq, x, "fixed", activations=True)
        torch.cuda.synchronize()
        _copies_change_nothing(wq, x, "fixed", out)
        want = []
        ref = kp.fixed_chain_ref(wq, x, want)
        moved = sum(int((a != w).sum()) for a, w in zip(acts["q"], want))
        mx, _ = gate_close(f"int8_scale_probe_fixed n={n}", out, ref, 2e-3,
                           p99_tol=2e-2)
        log(f"    fixed n={n}: {moved} of {4 * n * H} int8 activations one "
            f"step or more from the plain version's")
        errs["int8_scale_probe_fixed"] = max(errs["int8_scale_probe_fixed"],
                                             mx)
        out, acts = kp.probe_forward(wq, x, "mxu", activations=True)
        torch.cuda.synchronize()
        _copies_change_nothing(wq, x, "mxu", out)
        plain = []
        kp.mxu_chain_ref(wq, x, plain)
        rows_apart = int((acts["q"][0] != plain[0]).any(dim=1).sum())
        want = []
        ref = kp.mxu_hidden_ref(wq, acts["q"][0], want)
        _activations_equal(f"K5 mxu n={n}", acts, want)
        # From the first activation on only the decode sums in another
        # order: the f32 gate of K1.
        mx, _ = gate_close(f"int8_scale_probe_mxu n={n} (from its first "
                           f"activation)", out, ref, 1e-4, 1e-3)
        log(f"    mxu n={n}: {rows_apart} of {n} rows' first int8 "
            f"activation differ from the plain encode's (not gated)")
        errs["int8_scale_probe_mxu"] = max(errs["int8_scale_probe_mxu"], mx)
    errs["lifting_int8_dynamic"] = check_probe_dynamic(wq, gen)
    return errs


def check_probe_dynamic(wq, gen):
    """The probe's dynamic rows: K2 at each of PROBE_GROUPS at the rows the
    probe times (``time_probe``'s ns), output and per-group amax against
    ``lifting_forward_int8_ref(tile=g)`` and its groups' amax (zero rows
    pad the last group), at phase 3's K2 dynamic gates. Returns the
    largest output difference."""
    import torch
    from bilinear_tpu_torch.ops import int8_scale_probe as kp
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    x_all = torch.randn((max(TIME_NS), IN_F), generator=gen,
                        device=gen.device)
    err = 0.0
    for n in TIME_NS:
        x = x_all[:n]
        xb = x.to(torch.bfloat16)
        for g in PROBE_GROUPS:
            out, acts = kp.probe_forward(wq, x, "dynamic", g, activations=True)
            torch.cuda.synchronize()
            ref = pq.lifting_forward_int8_ref(wq, x, tile=g)
            mx, _ = gate_close(f"lifting_int8_dynamic probe n={n} group={g}",
                               out, ref, 2e-3, p99_tol=2e-2)
            err = max(err, mx)
            groups = -(-n // g)
            plain = []
            pq.forward_chain(wq, (None,) * 4,
                             pq._pad_rows(xb, groups * g).reshape(groups, g,
                                                                  IN_F),
                             plain)
            plain = torch.stack(plain)
            rel = float(((acts["amax"] - plain).abs() / plain).max())
            log(f"    dynamic n={n} group={g}: {groups} groups, amax max "
                f"rel diff {rel:.2e}")
            if rel > 1e-2:
                raise AssertionError(f"K2 dynamic n={n} group={g}: per-group "
                                     f"amax disagrees")
    return err


def probe_calls(wq, scales, x):
    """The probe's seven rows on rows ``x``, in its order: (variant, group
    rows, kernel call, plain call)."""
    from bilinear_tpu_torch.ops import int8_scale_probe as kp
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    rows = [("dynamic", g,
             lambda g=g: kp.probe_forward(wq, x, "dynamic", g),
             lambda g=g: pq.lifting_forward_int8_ref(wq, x, tile=g))
            for g in PROBE_GROUPS]
    rows += [("fixed", None, lambda: kp.probe_forward(wq, x, "fixed"),
              lambda: kp.fixed_chain_ref(wq, x)),
             ("mxu-bound", None, lambda: kp.probe_forward(wq, x, "mxu"),
              lambda: kp.mxu_chain_ref(wq, x)),
             ("production-entry", pq.GROUP,
              lambda: pq.lifting_forward_int8(x=x, prepared=wq),
              lambda: pq.lifting_forward_int8_ref(wq, x)),
             ("production-static", None,
              lambda: pq.lifting_forward_int8(x=x, prepared=wq,
                                              static_scales=scales),
              lambda: pq.lifting_forward_int8_ref(wq, x, scales))]
    return rows


def time_probe(params, stats, card, ns=TIME_NS):
    """The probe's seven rows (``probe_calls``) at each n of ``ns`` by CUDA
    events, plain version, kernel, kernel, plain version, beside K2's bound
    (the same products) and K2 static (the production-static row), on
    full-width seeded weights, the static scales calibrated on the probe's
    batch as the probe does. Returns the rows, each with the card."""
    import torch
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    wq = pq.prepare_weights_int8(params, stats, device=dev)
    x_all = torch.randn((max(max(ns), PROBE_BATCH), IN_F), generator=gen,
                        device=dev)
    scales = pq.calibrate_scales(wq, x_all[:PROBE_BATCH])
    rows = []
    for n in ns:
        x = x_all[:n]
        iters = 200 if n <= 4096 else 20
        b_ms, b_by = bound("int8", n)
        at_n = []
        for variant, group, kern, ref in probe_calls(wq, scales, x):
            p1 = cuda_ms(ref, iters)
            k1 = cuda_ms(kern, iters)
            k2 = cuda_ms(kern, iters)
            p2 = cuda_ms(ref, iters)
            ms = (k1 + k2) / 2
            at_n.append({
                "variant": variant, "group_rows": group, "n": n,
                "poses_per_sec": n / ms * 1e3, "ms": ms, "turns_ms": [k1, k2],
                "plain_ms": (p1 + p2) / 2,
                "bound_ms": b_ms, "bound_by": b_by, "card": card})
        static = at_n[-1]["ms"]
        for row in at_n:
            row["k2_static_ms"] = static
            log(f"  probe {row['variant']}"
                f"{'' if row['group_rows'] is None else ' ' + str(row['group_rows'])}"
                f" n={n}: {row['ms']:.4f} ms (turns {row['turns_ms'][0]:.4f},"
                f" {row['turns_ms'][1]:.4f}), {row['poses_per_sec']:.4g} "
                f"poses/s, plain {row['plain_ms']:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), K2 static {static:.4f} ms")
        rows += at_n
    return rows


def trace_probe(params, stats, ns=TIME_NS):
    """K5 fixed and mxu at each n of ``ns`` by a profiler trace: {(variant,
    n): (device ms per call, device kernels per call)}. Asserts one device
    kernel a call, K5's own."""
    import torch
    from bilinear_tpu_torch.ops import int8_scale_probe as kp
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    wq = pq.prepare_weights_int8(params, stats, device="cuda")
    out = {}
    for n in ns:
        # bf16 rows, as the kernel reads them: no cast in the trace
        x = torch.randn((n, IN_F), generator=gen, device="cuda").to(
            torch.bfloat16)
        for variant in ("fixed", "mxu"):
            per = _trace_whole(lambda: kp.probe_forward(wq, x, variant), 3)
            ms = sum(t for t, _ in per.values())
            count = round(sum(c for _, c in per.values()))
            log(f"  K5 {variant} n={n} by trace: {ms:.4f} ms, {count} device "
                f"kernel(s) a call: " + "; ".join(
                    f"{_short(k)} {t * 1e3:.1f} us ({c:.0f})"
                    for k, (t, c) in per.items()))
            if count != 1 or any("chain_kernel" not in k for k in per):
                raise AssertionError(f"K5 {variant} n={n}: not one launch of "
                                     f"its kernel a call: {list(per)}")
            out[variant, n] = (ms, count)
    return out


def drive_probe(params, stats, card):
    """Phase 3c: K5's checks, then the probe's rows (its main path) with
    K5's launches counted, then K5's trace (one device kernel a call).
    Returns (errs, rows, launches by kernel)."""
    from bilinear_tpu_torch.ops import int8_scale_probe as kp

    errs = check_probe(params, stats)
    for k in kp.LAUNCHES:
        kp.LAUNCHES[k] = 0
    rows = time_probe(params, stats, card)
    launches = {f"int8_scale_probe_{k}": n for k, n in kp.LAUNCHES.items()}
    log(f"  K5 launches over the probe's rows: {launches}")
    for k, n in launches.items():
        if not n:
            raise AssertionError(f"{k}: the kernel was not launched")
    traced = trace_probe(params, stats)
    for row in rows:
        v = {"fixed": "fixed", "mxu-bound": "mxu"}.get(row["variant"])
        if v is not None:
            row["trace_ms"], row["device_kernels_per_call"] = traced[v, row["n"]]
    return errs, rows, launches


# ------------------------------------------------------------ phase 3b

# Every ResModule shape of the full-width detector at batch 8 (B, H, W, Ci,
# Co), then tail batches whose row count N = B*H*W is no multiple of the
# kernels' 128-row tile: a training epoch's last batch runs the hourglass's
# 4x4 modules at N = 96, one partial tile; and a served End2End batch of
# one frame (N = 16 at 4x4).
RES_SHAPES = (
    (8, 128, 128, 64, 128),   # stem_res1, 1x1 skip
    (8, 64, 64, 128, 128),    # stem_res2
    (8, 64, 64, 128, 256),    # stem_res3, 1x1 skip
    (8, 64, 64, 256, 256),    # hourglass body, 5 resolutions
    (8, 32, 32, 256, 256),
    (8, 16, 16, 256, 256),
    (8, 8, 8, 256, 256),
    (8, 4, 4, 256, 256),
    (5, 16, 16, 256, 256),    # a tail batch of whole tiles
    (6, 4, 4, 256, 256),      # N = 96: the main path's tail step
    (3, 4, 4, 256, 256),      # N = 48: less than one weight-gradient chunk
    (5, 8, 8, 256, 256),      # N = 320: two whole tiles and half a tile
    (3, 8, 8, 128, 256),      # N = 192, 1x1 skip
    (1, 10, 20, 64, 128),     # N = 200, 1x1 skip, H != W, Ch = 64
    (1, 4, 4, 256, 256),      # N = 16: a served End2End batch of 1
    (1, 64, 64, 256, 256),    # the same batch's largest 256-wide modules
)
# Gates of K3/K4 against their plain versions: (mean |d|, max |d|), both
# relative to mean |ref|. The two sum in another order. f32 forward: ~1e-7
# relative. bf16: a value at a bf16 rounding boundary rounds one step apart
# (max: one step of the largest values) and carries into later stages. K4's
# outputs are column sums over up to 131072 rows, some of signed terms that
# nearly cancel (sum(gy) for beta), which magnifies rounding-order
# differences; and an element whose BN output lies within rounding distance
# of zero takes the other side of the ReLU in one of the two, which moves
# that element's gradient by its full size, so the max gates are loose.
# db1 and db2 are gradients of a bias followed by a train-mode BN: zero in
# exact arithmetic, so both sides return rounding noise; they are held to
# the scale of db3, a column sum over the same rows.
RES_GATES = {
    ("K3", "f32"): (1e-5, 1e-4), ("K3", "bf16"): (1e-3, 5e-2),
    ("K4", "f32"): (1e-3, 0.2), ("K4", "bf16"): (2e-2, 1.0),
}


def res_case(shape, seed, dev):
    """x, output gradient, parameters (torch init bounds) and scrambled BN
    statistics and gamma/beta, from a seeded torch.Generator on the card."""
    import math

    import torch
    from bilinear_tpu_torch.ops.resmodule import BatchStats, ResParams

    b, h, w, ci, co = shape
    ch = co // 2
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(size, fan_in):
        r = torch.rand(size, generator=gen, device=dev)
        return (2 * r - 1) / math.sqrt(fan_in)

    def nrm(c, base, scale):
        return base + scale * torch.randn(c, generator=gen, device=dev)

    def var(c):
        return torch.rand(c, generator=gen, device=dev) + 0.5

    skip = ci != co
    p = ResParams(
        w1=u((ci, ch), ci), b1=u(ch, ci), w2=u((9, ch, ch), 9 * ch),
        b2=u(ch, 9 * ch), w3=u((ch, co), ch), b3=u(co, ch),
        g1=nrm(ci, 1, 0.3), be1=nrm(ci, 0, 0.3), g2=nrm(ch, 1, 0.3),
        be2=nrm(ch, 0, 0.3), g3=nrm(ch, 1, 0.3), be3=nrm(ch, 0, 0.3),
        skip_w=u((ci, co), ci) if skip else None,
        skip_b=u(co, ci) if skip else None)
    stats = BatchStats(nrm(ci, 0, 0.2), var(ci), nrm(ch, 0, 0.2), var(ch),
                       nrm(ch, 0, 0.2), var(ch))
    x = 0.5 + 2 * torch.randn((b, h, w, ci), generator=gen, device=dev)
    g = torch.randn((b, h, w, co), generator=gen, device=dev)
    return x, g, p, stats


def check_running_update(x, p, stats, dtype, st, tag):
    """The running statistics K3 updates in place (momentum 0.1) against
    the plain update from the same batch statistics: the same f32 formula,
    so 1e-6 relative; and the batch statistics of that call must be the
    bits of the call without the update."""
    import torch
    from bilinear_tpu_torch.ops import resmodule as rm

    def fresh():
        return rm.RunningStats(
            tuple(t.clone() for t in stats[0::2]),
            tuple(t.clone() for t in stats[1::2]),
            tuple(torch.zeros((), dtype=torch.int64, device=x.device)
                  for _ in range(3)), 0.1)

    got, want = fresh(), fresh()
    st2 = rm._fwd_cuda(x, p, True, None, dtype, got)[1]
    torch.cuda.synchronize()
    if any(not torch.equal(a, b) for a, b in zip(st, st2)):
        raise AssertionError(f"K3 train {tag}: batch statistics change with "
                             f"the running update")
    b, h, w, _ = x.shape
    rm.update_running_ref(want, st, b * h * w)
    worst = 0.0
    for a, r in zip(got.mean + got.var, want.mean + want.var):
        worst = max(worst, float(((a - r).abs() / r.abs().clamp_min(1e-3))
                                 .max()))
    counts = [int(c) for c in got.count]
    log(f"  K3 train {tag} running statistics in place: max rel diff "
        f"{worst:.2e}, num_batches_tracked {counts}")
    if worst > 1e-6 or counts != [1, 1, 1]:
        raise AssertionError(f"K3 train {tag}: running statistics disagree")


WIDE_SHAPE = (1, 4, 320, 256, 256)


def check_wide_image(gate):
    """An image wider than the bf16 3x3's shared-memory tile takes (W <= 217
    at Ch = 128, 277 below 8192 rows) is refused by name in bf16, before anything is launched,
    and computed in f32."""
    import torch
    from bilinear_tpu_torch.ops import resmodule as rm

    x, g, p, stats = res_case(WIDE_SHAPE, SEED + 30, torch.device("cuda"))
    before = (rm.LAUNCHES_FWD_EVAL, rm.LAUNCHES_BWD)
    for call in (lambda: rm._fwd_cuda(x.bfloat16(), p, False, stats,
                                      torch.bfloat16),
                 lambda: rm._bwd_cuda(x.bfloat16(), g.bfloat16(), p, stats,
                                      torch.bfloat16)):
        try:
            call()
        except ValueError as e:
            if "image width 320" not in str(e):
                raise
        else:
            raise AssertionError(f"bf16 {WIDE_SHAPE} was not refused")
    if (rm.LAUNCHES_FWD_EVAL, rm.LAUNCHES_BWD) != before:
        raise AssertionError("a refused call was counted as a launch")
    log(f"  bf16 {WIDE_SHAPE}: refused with a ValueError that names the "
        f"width")
    out = rm._fwd_cuda(x, p, False, stats, torch.float32)[0]
    torch.cuda.synchronize()
    ref = rm.res_block_ref(x, p, train=False, stats=stats,
                           dtype=torch.float32)[0]
    gate(f"K3 eval f32 {WIDE_SHAPE} out", "f32", out, ref)


# The batch-16 shapes of the evaluation slice: the flip-TTA forward runs
# [crops; hflip(crops)] (262,144 stem rows), and its smallest modules.
RES_SHAPES_16 = (
    (16, 128, 128, 64, 128),  # stem_res1, 1x1 skip: 262,144 rows
    (16, 64, 64, 256, 256),
    (16, 4, 4, 256, 256),
)


def check_resmodule_16(gate, errs):
    """K3 eval and K3 train with ``running=None`` under ``no_grad`` (the
    recalibration pass: the cumulative update is Python's) at
    RES_SHAPES_16, bf16 and f32, against res_block_ref with the batch-8
    gates; the BN buffers of a ResModule whose parameters the call used
    must be bit-unchanged by it."""
    import torch
    from bilinear_tpu_torch.models.hourglass_torch7 import ResModule
    from bilinear_tpu_torch.ops import resmodule as rm

    dev = torch.device("cuda")
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for i, shape in enumerate(RES_SHAPES_16):
            x, _, _, stats = res_case(shape, SEED + 50 + i, dev)
            x = x.to(dtype)
            tag = f"{kind} {shape}"
            mod = ResModule(shape[3], shape[4], momentum=None, dtype=dtype,
                            fused=True).to(dev)
            s = mod.resSeq
            for bn, m, v in zip((s[0], s[3], s[6]), stats[0::2],
                                stats[1::2]):
                bn.running_mean.copy_(m)
                bn.running_var.copy_(v)
            before = [b.clone() for b in mod.buffers()]
            p = mod.res_params()
            with torch.no_grad():
                out, st = rm.res_block_train(x, p, dtype=dtype, running=None)
                torch.cuda.synchronize()
                ref, ref_st = rm.res_block_ref(x, p, train=True, dtype=dtype)
            e = gate(f"K3 train no_grad {tag} out", kind, out, ref)
            for name, a, b in zip(rm.BatchStats._fields, st, ref_st):
                e = max(e, gate(f"K3 train no_grad {tag} {name}", kind, a, b))
            errs["resmodule_fwd_train"] = max(errs["resmodule_fwd_train"], e)
            if not all(torch.equal(a, b) for a, b in zip(before,
                                                         mod.buffers())):
                raise AssertionError(f"K3 train {tag} with running=None "
                                     f"changed the BN buffers")
            with torch.no_grad():
                out = rm.res_block_eval(x, p, stats, dtype=dtype)
                torch.cuda.synchronize()
                ref = rm.res_block_ref(x, p, train=False, stats=stats,
                                       dtype=dtype)[0]
            errs["resmodule_fwd_eval"] = max(
                errs["resmodule_fwd_eval"],
                gate(f"K3 eval {tag} out", kind, out, ref))
            del x, stats, mod, p, out, st, ref, ref_st, before
            torch.cuda.empty_cache()
    log(f"  batch 16: the BN buffers were bit-unchanged by every "
        f"running=None call")


def check_resmodule():
    """K3 train (out + six stats), K3 eval and K4 (g_x + every parameter
    gradient) against res_block_ref / res_block_bwd_ref on the same CUDA
    inputs, at every RES_SHAPES entry, in bf16 and f32. Returns
    {kernel: max |d| over all cases}; raises after logging every case when
    any is out of its gate."""
    import torch
    from bilinear_tpu_torch.ops import resmodule as rm

    dev = torch.device("cuda")
    errs = {"resmodule_fwd_train": 0.0, "resmodule_fwd_eval": 0.0,
            "resmodule_bwd": 0.0}
    failed = []

    def gate(name, kind, out, ref, scale_of=None):
        try:
            mx, _ = gate_close(name, out, ref, *RES_GATES[name[:2], kind],
                               scale_of=scale_of)
        except AssertionError as e:
            failed.append(str(e))
            mx = float((out.float() - ref.float()).abs().max())
        return mx

    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for i, shape in enumerate(RES_SHAPES):
            x, g, p, stats = res_case(shape, SEED + 10 + i, dev)
            x = x.to(dtype)
            tag = f"{kind} {shape}"
            out, st = rm._fwd_cuda(x, p, True, None, dtype)
            torch.cuda.synchronize()
            ref, ref_st = rm.res_block_ref(x, p, train=True, dtype=dtype)
            e = gate(f"K3 train {tag} out", kind, out, ref)
            for name, a, b in zip(rm.BatchStats._fields, st, ref_st):
                e = max(e, gate(f"K3 train {tag} {name}", kind, a, b))
            errs["resmodule_fwd_train"] = max(errs["resmodule_fwd_train"], e)
            check_running_update(x, p, stats, dtype, st, tag)

            out = rm._fwd_cuda(x, p, False, stats, dtype)[0]
            torch.cuda.synchronize()
            ref = rm.res_block_ref(x, p, train=False, stats=stats,
                                   dtype=dtype)[0]
            errs["resmodule_fwd_eval"] = max(
                errs["resmodule_fwd_eval"],
                gate(f"K3 eval {tag} out", kind, out, ref))

            gx, gp = rm._bwd_cuda(x, g, p, ref_st, dtype)
            torch.cuda.synchronize()
            rgx, rgp = rm.res_block_bwd_ref(x, g, p, ref_st, dtype=dtype)
            e = gate(f"K4 {tag} g_x", kind, gx, rgx)
            for name, a, b in zip(rm.ResParams._fields, gp, rgp):
                if b is not None:
                    e = max(e, gate(f"K4 {tag} d{name}", kind, a, b,
                                    rgp.b3 if name in ("b1", "b2") else None))
            errs["resmodule_bwd"] = max(errs["resmodule_bwd"], e)
            del x, g, p, stats, out, st, ref, ref_st, gx, gp, rgx, rgp
    check_resmodule_16(gate, errs)
    check_wide_image(gate)
    if failed:
        raise AssertionError(f"{len(failed)} resmodule cases out of "
                             f"tolerance:\n" + "\n".join(failed))
    return errs


# Staged K3/K4 (phase 16): the shapes a data-parallel step gives each rank
# (2 ranks x 4 rows of the full-width detector's batch 8: the stem block,
# the hourglass body at its largest and smallest) and two uneven splits.
STAGED_SHAPES = (
    (8, 128, 128, 64, 128),
    (8, 64, 64, 256, 256),
    (8, 4, 4, 256, 256),
    (5, 8, 8, 256, 256),     # shards of 2 and 3 rows
    (3, 8, 8, 128, 256),     # 1 and 2 rows, 1x1 skip
)


class ThreadRanks:
    """``world`` ranks as threads of this process on one card: an exchange
    whose gather meets the other threads at a barrier and stacks their rows
    in rank order (every stage kernel that wrote a row was enqueued on the
    card's one stream before the barrier). ``skip`` names an exchange (0,
    1, 2: the forward's BNs; 3, 4, 5: the backward's) that returns the
    rank's own row alone: a planted fault, rank-local statistics."""

    def __init__(self, world, skip=None):
        self.world, self.skip = world, skip
        self.barrier = threading.Barrier(world)
        self.rows = [None] * world

    def exchange(self, rank, total):
        from bilinear_tpu_torch.ops.resmodule import RankExchange
        import torch

        calls = [0]

        def gather(row):
            k, calls[0] = calls[0], calls[0] + 1
            if k == self.skip:
                return row[None]
            self.rows[rank] = row
            self.barrier.wait()
            out = torch.stack(self.rows)
            self.barrier.wait()
            return out

        return RankExchange(gather, total)

    def run(self, fn):
        """fn(rank) in one thread per rank; their results in rank order."""
        out, errs = [None] * self.world, []

        def body(r):
            try:
                out[r] = fn(r)
            except BaseException as e:  # re-raised below
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


def _running_copy(stats, dev):
    import torch
    from bilinear_tpu_torch.ops import resmodule as rm

    return rm.RunningStats(
        tuple(t.clone() for t in stats[0::2]),
        tuple(t.clone() for t in stats[1::2]),
        tuple(torch.zeros((), dtype=torch.int64, device=dev)
              for _ in range(3)), 0.1)


def staged_ranks(x, g, p, dtype, ranks, stats, blocks=None):
    """The staged K3 train forward (with a running update) and K4 over
    ``ranks.world`` row blocks of (x, g) (``blocks``, else equal ones),
    each block a thread: (out and g_x joined, the batch statistics of rank
    0, running statistics of rank 0, the parameter gradients summed over
    the ranks in rank order, the per-rank batch statistics)."""
    import torch
    from bilinear_tpu_torch.ops import resmodule as rm

    b = x.shape[0]
    blocks = blocks or [((r * b) // ranks.world, ((r + 1) * b) // ranks.world)
                        for r in range(ranks.world)]

    def one(r):
        lo, hi = blocks[r]
        ex = ranks.exchange(r, b)
        run = _running_copy(stats, x.device)
        out, st = rm._fwd_cuda(x[lo:hi], p, True, None, dtype, run, ex)
        gx, gp = rm._bwd_cuda(x[lo:hi], g[lo:hi], p, st, dtype, ex)
        torch.cuda.synchronize()
        return out, st, run, gx, gp

    res = ranks.run(one)
    grads = [None if t is None else sum(r[4][i] for r in res)
             for i, t in enumerate(res[0][4])]
    return (torch.cat([r[0] for r in res]), res[0][1], res[0][2],
            torch.cat([r[3] for r in res]), rm.ResParams(*grads),
            [r[1] for r in res])


def check_staged_resmodule():
    """The staged K3/K4 (phase 16). One rank: the four stage entries give
    the unstaged call's bits (output, batch and running statistics, g_x,
    every gradient), and so do two ranks of which the first holds no row
    (it launches no GEMM, sends rows of count 0 and of zeros, and its
    statistics, running statistics and zero gradients are still the
    unstaged call's). Two ranks as threads on the card: every rank holds
    the same statistics bit for bit, and the joined output and g_x, the
    statistics, the running statistics and the gradients summed over the
    ranks are held against the plain versions on the whole batch at
    RES_GATES. A planted fault, the first exchange skipped (rank-local
    statistics for the first BN), must fail that gate. Returns {kernel:
    max |d|}."""
    import torch
    from bilinear_tpu_torch.ops import resmodule as rm

    dev = torch.device("cuda")
    errs = {"resmodule_fwd_train": 0.0, "resmodule_bwd": 0.0}
    one_rank = empty_rank = 0
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for i, shape in enumerate(STAGED_SHAPES):
            x, g, p, stats = res_case(shape, SEED + 70 + i, dev)
            x, g = x.to(dtype), g.to(dtype)
            tag = f"{kind} {shape}"
            b = shape[0]
            # One rank: staged against unstaged, bit for bit.
            ra, rb = _running_copy(stats, dev), _running_copy(stats, dev)
            alone = rm.RankExchange(lambda row: row[None], b)
            out_a, st_a = rm._fwd_cuda(x, p, True, None, dtype, ra)
            out_b, st_b = rm._fwd_cuda(x, p, True, None, dtype, rb, alone)
            gx_a, gp_a = rm._bwd_cuda(x, g, p, st_a, dtype)
            gx_b, gp_b = rm._bwd_cuda(x, g, p, st_a, dtype, alone)
            torch.cuda.synchronize()
            pairs = [(out_a, out_b), (gx_a, gx_b)] + list(zip(st_a, st_b)) \
                + list(zip(ra.mean + ra.var + ra.count,
                           rb.mean + rb.var + rb.count)) \
                + [(u, v) for u, v in zip(gp_a, gp_b) if u is not None]
            if not all(torch.equal(u, v) for u, v in pairs):
                raise AssertionError(f"staged K3/K4 {tag}, one rank: not the "
                                     f"unstaged call's bits")
            one_rank += 1
            # Two ranks, the first holding no row: the unstaged call's bits.
            out_e, st_e, run_e, gx_e, gp_e, per_rank = staged_ranks(
                x, g, p, dtype, ThreadRanks(2), stats,
                blocks=[(0, 0), (0, b)])
            pairs = [(out_a, out_e), (gx_a, gx_e)] + list(zip(st_a, st_e)) \
                + list(zip(st_a, per_rank[1])) \
                + list(zip(ra.mean + ra.var + ra.count,
                           run_e.mean + run_e.var + run_e.count)) \
                + [(u, v) for u, v in zip(gp_a, gp_e) if u is not None]
            if not all(torch.equal(u, v) for u, v in pairs):
                raise AssertionError(f"staged K3/K4 {tag}, an empty rank 0: "
                                     f"not the unstaged call's bits")
            empty_rank += 1
            # Two ranks against the plain versions on the whole batch.
            out, st, run, gx, gp, per_rank = staged_ranks(
                x, g, p, dtype, ThreadRanks(2), stats)
            if not all(torch.equal(u, v) for u, v in zip(per_rank[0],
                                                         per_rank[1])):
                raise AssertionError(f"staged K3 {tag}: the ranks' "
                                     f"statistics differ")
            ref, ref_st = rm.res_block_ref(x, p, train=True, dtype=dtype)
            rgx, rgp = rm.res_block_bwd_ref(x, g, p, ref_st, dtype=dtype)
            want = _running_copy(stats, dev)
            rm.update_running_ref(want, ref_st, b * shape[1] * shape[2])
            gate = RES_GATES["K3", kind]
            e = gate_close(f"staged K3 2 ranks {tag} out", out, ref,
                           *gate)[0]
            for name, u, v in zip(rm.BatchStats._fields, st, ref_st):
                e = max(e, gate_close(f"staged K3 2 ranks {tag} {name}", u,
                                      v, *gate)[0])
            for j, (u, v) in enumerate(zip(run.mean + run.var,
                                           want.mean + want.var)):
                e = max(e, gate_close(f"staged K3 2 ranks {tag} running "
                                      f"{j}", u, v, *gate)[0])
            if [int(c) for c in run.count] != [1, 1, 1]:
                raise AssertionError(f"staged K3 {tag}: counts {run.count}")
            errs["resmodule_fwd_train"] = max(errs["resmodule_fwd_train"], e)
            gate = RES_GATES["K4", kind]
            e = gate_close(f"staged K4 2 ranks {tag} g_x", gx, rgx, *gate)[0]
            for name, u, v in zip(rm.ResParams._fields, gp, rgp):
                if v is not None:
                    e = max(e, gate_close(
                        f"staged K4 2 ranks {tag} d{name} (sum of ranks)", u,
                        v, *gate,
                        scale_of=rgp.b3 if name in ("b1", "b2") else None)[0])
            errs["resmodule_bwd"] = max(errs["resmodule_bwd"], e)
            if i == 1:  # the planted fault at the hourglass body's shape
                out_f, st_f = staged_ranks(x, g, p, dtype,
                                           ThreadRanks(2, skip=0),
                                           stats)[:2]
                try:
                    gate_close(f"planted fault {tag}: m1 without its "
                               f"exchange", st_f.m1, ref_st.m1,
                               *RES_GATES["K3", kind])
                except AssertionError:
                    log(f"  planted fault {tag} (first exchange skipped): "
                        "failed the gate, as it must")
                else:
                    raise AssertionError("a staged K3 without its first "
                                         "exchange passed the gate")
            del x, g, p, stats, out, st, run, gx, gp, ref, ref_st, rgx, rgp
            torch.cuda.empty_cache()
    log(f"  staged K3/K4: {one_rank} one-rank cases and {empty_rank} "
        f"cases with an empty rank 0 the unstaged call's bits")
    return errs


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


def serve_dirs(work):
    return os.path.join(work, "Human3.6M"), os.path.join(work, "run")


def build_daemon(work, dtype, quantize, max_delay_ms):
    """The daemon of cli/serve.py on the dataset and checkpoint under
    ``work``, on a free port."""
    from bilinear_tpu_torch.cli import serve

    data_dir, run_dir = serve_dirs(work)
    return serve.build_server(serve.build_parser().parse_args([
        "--run-dir", run_dir, "--data-dir", data_dir, "--dtype", dtype,
        "--quantize", quantize, "--port", "0", "--reload-every", "0",
        "--max-delay-ms", str(max_delay_ms),
    ]))


def drive_slice(work):
    """Serve every mode over HTTP; returns {label: launches} counted over
    the requests alone, and the served and plain MPJPE per mode."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.client import PoseClient
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
    from bilinear_tpu_torch.eval.mpjpe import evaluate_mpjpe
    from bilinear_tpu_torch.io.checkpoint import save_checkpoint
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq
    from bilinear_tpu_torch.utils.weights import bilinear_to_jax

    counters = {"lifting": pl, "lifting_int8": pq}
    data_dir, run_dir = serve_dirs(work)
    pdir = os.path.join(run_dir, "parameter")
    write_h36m_dataset(data_dir, n_train=8192, n_valid=4096, seed=SEED)
    save_checkpoint(pdir, 1, *bilinear_to_jax(random_state_dict(SEED)))
    splits = load_h36m(data_dir)
    kp_pool = splits[Task.Train].raw_part.reshape(-1, 16, 2)
    launches, mpjpe = {}, {}
    for label, dtype, quantize, counter in MODES:
        http = build_daemon(work, dtype, quantize, max_delay_ms=20)
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
            save_checkpoint(pdir, 2,
                            *bilinear_to_jax(random_state_dict(SEED + 2)))
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


def lift_kernel_caps():
    """Device kernels one call of a lifting kernel wrapper may launch, at a
    serving batch and at bulk size (TIME_NS): one cooperative launch, or one
    launch per layer; dynamic mode adds the memset of its scratch (its
    producing layers quantise their own output: no quantise pass at these
    sizes)."""
    from bilinear_tpu_torch.ops.lifting_int8 import dynamic_launches

    return {"lifting_bf16": (1, 6), "lifting_f32": (6, 6),
            "lifting_int8_dynamic": tuple(dynamic_launches(n)
                                          for n in TIME_NS),
            "lifting_int8_static": (1, 6)}


def lifting_calls(params, stats, scales, n, gen):
    """{mode: call of the kernel wrapper on prepared rows} at n rows: what
    LiftingServer runs per dispatch, less the casts and the padding row."""
    import torch
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    dev = torch.device("cuda")
    w16 = pl.prepare_weights(params, stats, torch.bfloat16, device=dev)
    w32 = pl.prepare_weights(params, stats, torch.float32, device=dev)
    wq = pq.prepare_weights_int8(params, stats, device=dev)
    x = torch.randn((n, IN_F), generator=gen, device=dev)
    x16 = x.to(torch.bfloat16)
    xpad = pq._pad_rows(x16, n + 1) if n % pq.GROUP else x16

    def calls(path=None):
        return {
            "lifting_bf16": lambda: pl.lifting_forward_cuda(w16, x16,
                                                            path=path),
            "lifting_f32": lambda: pl.lifting_forward_cuda(w32, x),
            "lifting_int8_dynamic": lambda: pq._launch(
                wq, xpad, (None,) * 4, pq.GROUP, path=path),
            "lifting_int8_static": lambda: pq._launch(
                wq, x16, tuple(scales), pq._ONE_GROUP, path=path),
        }

    return calls


def _short(key: str) -> str:
    return key.split("(")[0].replace("void ", "").replace("lifting::", "") \
        .replace("__nv_bfloat16", "bf16").replace("signed char", "s8")


def trace_lifting(params, stats, scales, table):
    """Device kernels per call and their summed time from a profiler trace,
    at both TIME_NS in the four modes, into ``table``. Asserts the caps of
    lift_kernel_caps(), that every device kernel of a call is one of this
    repo's (``lifting::...``) or a memset, and that the bf16 and int8 modes
    multiply in the wgmma kernels. Logs each call by kernel."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for i, n in enumerate(TIME_NS):
        for name, fn in lifting_calls(params, stats, scales, n, gen)().items():
            fn()
            per = _trace_whole(fn, 3)
            row = table[name][n]
            row["trace_ms"] = sum(ms for ms, _ in per.values())
            row["device_kernels_per_call"] = round(
                sum(cnt for _, cnt in per.values()))
            by_kernel = "; ".join(
                f"{_short(k)} {ms * 1e3:.1f} ({cnt:.0f})" for k, (ms, cnt)
                in sorted(per.items(), key=lambda kv: -kv[1][0]))
            log(f"  {name} n={n}: {row['device_kernels_per_call']} device "
                f"kernels per call, {row['trace_ms']:.4f} ms as the trace's "
                f"sum; by kernel, us per call (launches): {by_kernel}")
            cap = lift_kernel_caps()[name][i]
            if row["device_kernels_per_call"] > cap:
                raise AssertionError(f"{name} n={n}: more than {cap} device "
                                     f"kernels per call")
            foreign = [k for k in per if "lifting::" not in k
                       and not k.startswith("Memset")]
            if foreign:
                raise AssertionError(f"{name} n={n}: device kernels from "
                                     f"outside csrc/: {foreign}")
            products = [k for k in per if "gemm" in k or "chain" in k]
            if name != "lifting_f32" and (
                    not products or any("wgmma" not in k for k in products)):
                raise AssertionError(f"{name} n={n}: the products do not run "
                                     f"in the wgmma kernels: {list(per)}")


def check_bulk_route(params, stats):
    """K1's route counter: bf16 calls of ``lifting_forward`` at the bulk
    size take the persistent kernel, every one of them, and a serving batch
    the one-launch kernel; nothing takes the per-layer GEMM."""
    import torch
    from bilinear_tpu_torch.ops import lifting as pl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    w16 = pl.prepare_weights(params, stats, torch.bfloat16, device=dev)
    before = dict(pl.ROUTE_CALLS)
    for n in (TIME_NS[1],) * 3 + (TIME_NS[0],):
        x = torch.randn((n, IN_F), generator=gen, device=dev)
        pl.lifting_forward(None, None, x, prepared=w16)
    torch.cuda.synchronize()
    moved = {k: pl.ROUTE_CALLS[k] - before[k] for k in before}
    log(f"  K1 routes taken by 3 calls at n={TIME_NS[1]} and 1 at "
        f"n={TIME_NS[0]}: {moved}")
    if moved != {"fused": 1, "layers": 0, "persistent": 3}:
        raise AssertionError(f"K1's bulk calls took other routes: {moved}")


def time_bulk_routes(params, stats):
    """K1 bf16 through the per-layer GEMM ("layers") and through the
    persistent kernel ("persistent") at row counts on both sides of
    ops.lifting.PERSISTENT_MIN_ROWS and at the bulk size: device time from a
    trace and CUDA events (layers, persistent, persistent, layers). The
    boundary stands where the two meet. Measurement only."""
    import torch
    from bilinear_tpu_torch.ops import lifting as pl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    w16 = pl.prepare_weights(params, stats, torch.bfloat16, device=dev)
    out = {}
    for n in (pl.FUSED_MAX_ROWS + 1, pl.PERSISTENT_MIN_ROWS - 1,
              pl.PERSISTENT_MIN_ROWS, 4097, TIME_NS[1]):
        x = torch.randn((n, IN_F), generator=gen, device=dev).to(
            torch.bfloat16)
        iters = 200 if n <= 4097 else 20
        row = {}
        for route in ("layers", "persistent", "persistent", "layers"):
            row.setdefault(route, []).append(cuda_ms(
                lambda r=route: pl.lifting_forward_cuda(w16, x, path=r), iters))
        for route in ("layers", "persistent"):
            per = _trace_whole(
                lambda r=route: pl.lifting_forward_cuda(w16, x, path=r), 5)
            row[route] = {"events_ms": sum(row[route]) / 2,
                          "trace_ms": sum(ms for ms, _ in per.values())}
        out[n] = row
        log(f"  K1 bf16 n={n}: per-layer GEMM {row['layers']['trace_ms']:.4f} "
            f"ms by trace ({row['layers']['events_ms']:.4f} by events), "
            f"persistent kernel {row['persistent']['trace_ms']:.4f} "
            f"({row['persistent']['events_ms']:.4f}); default route "
            f"{pl.choose_route(n, torch.bfloat16)}")
    return out


def time_path_boundary(params, stats, scales):
    """Both kernel paths at the largest row count the one-launch path takes
    (ops.lifting.FUSED_MAX_ROWS) and at twice that: device time from a
    trace, and CUDA events (which hold host time where the wrapper is slower
    than the card). The boundary stands where the two meet."""
    import torch
    from bilinear_tpu_torch.ops.lifting import FUSED_MAX_ROWS

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    out = {}
    for n in (FUSED_MAX_ROWS, 2 * FUSED_MAX_ROWS):
        calls = lifting_calls(params, stats, scales, n, gen)
        for path in ("fused", "layers"):
            for name, fn in calls(path).items():
                if name == "lifting_f32":
                    continue
                fn()
                per = _trace_whole(fn, 5)
                out[name, n, path] = (sum(ms for ms, _ in per.values()),
                                      cuda_ms(fn, 100))
        log(f"  n={n}, one launch / one launch per layer, ms by trace "
            f"(by events): " + "; ".join(
                f"{name} {out[name, n, 'fused'][0]:.4f} "
                f"({out[name, n, 'fused'][1]:.4f}) / "
                f"{out[name, n, 'layers'][0]:.4f} "
                f"({out[name, n, 'layers'][1]:.4f})"
                for name in lift_kernel_caps() if name != "lifting_f32"))
    return out


def time_weight_checks(params, stats):
    """Host time the wrappers spend on their weights per call: the usual
    recheck (identity and address of every prepared tensor) against a full
    validation (shapes, types, devices, alignment), which runs only when a
    tensor was replaced. Mean of 2000 calls on the host clock; measurement
    only."""
    import torch
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    dev = torch.device("cuda", torch.cuda.current_device())
    w16 = pl.prepare_weights(params, stats, torch.bfloat16, device=dev)
    wq = pq.prepare_weights_int8(params, stats, device=dev)
    x = torch.zeros((1, IN_F), dtype=torch.bfloat16, device=dev)

    def forget(holder, fn):
        def run():
            holder.checked = None
            fn()
        return run

    out = {}
    for name, holder, fn in (
            ("K1", w16, lambda: pl._weight_pointers(w16, x)),
            ("K2", wq, lambda: pq._weight_pointers(wq, dev))):
        for what, run in (("recheck", fn), ("full", forget(holder, fn))):
            run()
            t0 = time.perf_counter()
            for _ in range(2000):
                run()
            out[name, what] = (time.perf_counter() - t0) / 2000 * 1e6
    log("  host us per call on the weights, identity recheck / full "
        "validation: " + "; ".join(
            f"{k} {out[k, 'recheck']:.2f} / {out[k, 'full']:.2f}"
            for k in ("K1", "K2")))
    return out


def time_end_to_end(work):
    """Per serving mode: poses/s of LiftingServer at n = 65536 rows already
    on the card (lift_normalized: the forward and its allocations; lift: with
    normalisation and un-normalisation), host clock around synchronised
    calls; and the wall latency of /v1/lift (.npy bodies, one request at a
    time, 200 requests per size) at 1, 16 and 256 rows against the daemon
    with --max-delay-ms 0. Measurements only."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.client import PoseClient

    n, calls, requests = TIME_NS[1], 20, 200
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn((n, IN_F), generator=gen, device="cuda")
    kp = 500.0 + 100.0 * torch.randn((n, 16, 2), generator=gen, device="cuda")
    kp_host = kp[:256].cpu().numpy()
    out = {}
    for label, dtype, quantize, _ in MODES:
        http = build_daemon(work, dtype, quantize, max_delay_ms=0)
        http.warm()
        lifting = http.lifting
        row = {}
        for what, fn in (("lift_normalized", lambda: lifting.lift_normalized(x)),
                         ("lift", lambda: lifting.lift(kp))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            row[f"{what}_poses_per_s"] = n * calls / (time.perf_counter() - t0)
        http.start()
        try:
            client = PoseClient(f"http://{http.host}:{http.port}")
            for rows in SERVE_ROWS:
                body = kp_host[:rows]
                for _ in range(10):
                    client.lift(body)
                secs = []
                for _ in range(requests):
                    t0 = time.perf_counter()
                    client.lift(body)
                    secs.append(time.perf_counter() - t0)
                row[f"latency_ms_{rows}"] = {
                    "p50": float(np.percentile(secs, 50)) * 1e3,
                    "p99": float(np.percentile(secs, 99)) * 1e3}
        finally:
            http.stop()
        out[label] = row
        log(f"  {label}: {row['lift_normalized_poses_per_s']:.0f} poses/s "
            f"lift_normalized, {row['lift_poses_per_s']:.0f} poses/s lift at "
            f"n={n}; /v1/lift wall latency p50 / p99 ms over {requests} "
            f"requests: " + ", ".join(
                f"{rows} rows {row[f'latency_ms_{rows}']['p50']:.3f} / "
                f"{row[f'latency_ms_{rows}']['p99']:.3f}"
                for rows in SERVE_ROWS))
    return out


# ------------------------------------------------------------ phase 6

# ResModules per forward of the full-width detector: 3 in the stem and 13
# per stack (res1/res2/res3 at 4 levels + the waist), 8 stacks.
RES_PER_FORWARD = 3 + 8 * 13
DETECTOR_BATCH = 8
N_TRAIN_IMAGES = 16  # 90% of them (14) in the train split: 2 steps


def _res_counts():
    from bilinear_tpu_torch.ops import resmodule as rm

    return {"resmodule_fwd_train": rm.LAUNCHES_FWD_TRAIN,
            "resmodule_fwd_eval": rm.LAUNCHES_FWD_EVAL,
            "resmodule_bwd": rm.LAUNCHES_BWD}


def _zero_res_counts():
    from bilinear_tpu_torch.ops import resmodule as rm

    rm.LAUNCHES_FWD_TRAIN = rm.LAUNCHES_FWD_EVAL = rm.LAUNCHES_BWD = 0


def drive_detector(work):
    """Train the full-width detector through the CLI, twice (the second
    resumes), with --fused-blocks true in bf16; every ResModule of every
    step must go through K3/K4. Returns (launches, data dir, losses)."""
    import math

    from bilinear_tpu_torch.cli import train_hourglass
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations
    from bilinear_tpu_torch.data.synthetic import write_mpii_dataset
    from bilinear_tpu_torch.models import hourglass_torch7 as hg

    data_dir = os.path.join(work, "MPII")
    save_root = os.path.join(work, "save")
    write_mpii_dataset(data_dir, n_train_images=N_TRAIN_IMAGES,
                       n_test_images=2, learnable=True, seed=SEED)
    # The train/valid split is drawn here, from SEED, and persisted: the
    # CLI would draw it at random, and phase 7's batch and phase 10's
    # splits would change from run to run.
    n_records = len(MPIIAnnotations(data_dir, Task.Train, split_seed=SEED))
    steps = -(-n_records // DETECTOR_BATCH)
    argv = ["--data-dir", data_dir, "--save-root", save_root,
            "--comment", "smoke", "--dtype", "bfloat16",
            "--fused-blocks", "true", "--epochs-per-run", "1",
            "--batch-size", str(DETECTOR_BATCH), "--seed", str(SEED)]
    run_dir = os.path.join(save_root, "smoke")
    launches = {k: 0 for k in _res_counts()}
    losses = []
    python_updates = []
    real_update = hg.update_running_stats
    hg.update_running_stats = lambda *a, **k: (python_updates.append(1),
                                               real_update(*a, **k))
    for invocation in (1, 2):
        _zero_res_counts()
        t0 = time.perf_counter()
        try:
            train_hourglass.main(argv)
        finally:
            if invocation == 2:
                hg.update_running_stats = real_update
        secs = time.perf_counter() - t0
        count = _res_counts()
        log(f"  invocation {invocation}: {n_records} records, {steps} steps "
            f"of batch <= {DETECTOR_BATCH}, {secs:.1f} s; launches {count}")
        want = {"resmodule_fwd_train": RES_PER_FORWARD * steps,
                "resmodule_bwd": RES_PER_FORWARD * steps,
                "resmodule_fwd_eval": RES_PER_FORWARD}  # one overlay forward
        if count != want:
            raise AssertionError(f"launches {count}, expected {want}: a "
                                 f"ResModule took another path")
        for k, v in count.items():
            launches[k] += v
        with open(os.path.join(run_dir, "debug.log")) as f:
            text = f.read()
        line = [ln for ln in text.splitlines()
                if f"Epoch {invocation} saved" in ln]
        if not line:
            raise AssertionError(f"no 'Epoch {invocation} saved' line")
        loss = float(line[-1].split("loss: ")[1].split(",")[0])
        log(f"  {line[-1].split('> ')[-1]}")
        if not math.isfinite(loss):
            raise AssertionError(f"loss {loss} is not finite")
        losses.append(loss)
        if not os.path.exists(os.path.join(run_dir, "parameter",
                                           f"{invocation}.save")):
            raise AssertionError(f"{invocation}.save was not written")
    if python_updates:
        raise AssertionError(f"{len(python_updates)} running-statistics "
                             f"updates went through Python; the kernels "
                             f"update them in place")
    log("  every running-statistics update was made by the kernels")
    if "Resumed from epoch 1" not in text:
        raise AssertionError("the second invocation did not resume")
    log("  the second invocation logged 'Resumed from epoch 1' and wrote "
        "2.save")
    return launches, data_dir, losses


# ------------------------------------------------------------ phase 7

# Full-width step parity: fused (K3/K4) against the standard conv path
# (cuDNN + torch BN), from one state on one batch. The two compute the same
# function in another order. f32 gates, fused against standard: the loss's
# relative difference, and the median and 90th percentile over parameter
# tensors of |g_k - g_p| / |g_p|. In bf16 both paths round at every layer
# (at other points: cuDNN's conv epilogue, torch's BN kernels) through 8
# stacks, and the gradients of a randomly initialised net move far from the
# f32 ones on either path; so each bf16 path is held against the f32
# standard gradients, and the fused one may be at most PARITY_BF16_RATIO
# times as far as the standard one (median and 90th percentile). Every conv
# bias but the heatmap heads' only shifts channels that a later train-mode
# BN removes again, so its gradient is zero in exact arithmetic and rounding
# noise on both sides (norms ~1e-8 in the CPU tests): those are reported,
# not gated.
PARITY_F32 = (1e-4, 1e-2, 5e-2)
PARITY_BF16_LOSS = 2e-2
PARITY_BF16_RATIO = 1.5


def _parity_batch(data_dir, dev):
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
    from bilinear_tpu_torch.train import hourglass as th

    pipe = MPIIHostPipeline(MPIIAnnotations(data_dir, Task.Train),
                            DETECTOR_BATCH, shuffle=True, seed=SEED,
                            transport="u8")
    batch = next(iter(pipe.epoch(1, prefetch=0)))
    trainer = th.HourglassTrainer(device=dev)
    b = trainer.batch_tensors(batch)
    aug = th.sample_augment(th.step_generator(SEED, 1, 1),
                            b["images"].shape[0])
    crops, targets, _ = th.preprocess_batch(
        b["images"], b["centers"], b["scales"], b["keypoints"], b["valid"],
        aug)
    return crops, targets


def _rel_errors(grads, ref, gated):
    """Sorted (|g - r| / |r|, name) over the gated tensors."""
    return sorted((float((grads[k] - r).norm() / r.norm().clamp_min(1e-30)),
                   k) for k, r in ref.items() if k in gated)


def _quantiles(rel):
    return {q: rel[int(q * (len(rel) - 1))][0] for q in (0.5, 0.9)}


def step_parity(data_dir):
    """Loss and per-tensor gradients of MainModel(fused=True) against
    MainModel(fused=False) at full width, from one state and one batch."""
    import torch
    from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
    from bilinear_tpu_torch.train.hourglass import heatmap_loss

    dev = torch.device("cuda")
    crops, targets = _parity_batch(data_dir, dev)
    base = MainModel(generator=torch.Generator().manual_seed(SEED))
    sd = base.state_dict()
    shift_only = {f"{m}.bias" for m, mod in base.named_modules()
                  if isinstance(mod, torch.nn.Conv2d)
                  and not m.startswith("htmapArray.")}
    del base
    grads, losses, buffers = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        for fused in (True, False):
            model = MainModel(dtype=getattr(torch, dtype), fused=fused)
            model.load_state_dict(sd)
            model.to(dev).train()
            loss = heatmap_loss(model(crops), targets)
            loss.backward()
            losses[dtype, fused] = float(loss.detach())
            grads[dtype, fused] = {k: p.grad.detach().clone()
                                   for k, p in model.named_parameters()
                                   if p.grad is not None}
            buffers[dtype, fused] = {k: b.detach().clone()
                                     for k, b in model.named_buffers()}
            del model, loss
            torch.cuda.empty_cache()
    # The BN buffers after that one step, f32: the fused path's kernels
    # update them in place, the standard path's are torch's own. Both take
    # the same statistics of activations that agree to ~1e-6, so 1e-4.
    worst = 0.0
    for k, ref in buffers["float32", False].items():
        got = buffers["float32", True][k]
        if k.endswith("num_batches_tracked"):
            if int(got) != int(ref):
                raise AssertionError(f"{k}: {int(got)} fused, {int(ref)} "
                                     f"standard")
        else:
            worst = max(worst, float(((got - ref).abs()
                                      / ref.abs().clamp_min(1e-2)).max()))
    log(f"  float32: BN running statistics after the step, fused vs "
        f"standard, max rel diff {worst:.2e} over "
        f"{len(buffers['float32', False])} buffers")
    if worst > 1e-4:
        raise AssertionError("the fused path's running statistics disagree")
    keys = grads["float32", False].keys()
    if any(g.keys() != keys for g in grads.values()):
        raise AssertionError("the two paths train different tensors")
    gated = [k for k in keys if k not in shift_only]
    exact = f64_gaps(sd, crops, targets, grads, gated)
    result, failed = {"float64": exact}, []
    for dtype in ("float32", "bfloat16"):
        dloss = abs(losses[dtype, True] - losses[dtype, False]) / \
            abs(losses[dtype, False])
        rel = _rel_errors(grads[dtype, True], grads[dtype, False], gated)
        noise = _rel_errors(grads[dtype, True], grads[dtype, False],
                            shift_only)
        q = _quantiles(rel)
        log(f"  {dtype}: loss fused {losses[dtype, True]!r} standard "
            f"{losses[dtype, False]!r} (rel {dloss:.2e}); fused vs standard "
            f"|g_k - g_p|/|g_p| over {len(rel)} tensors: median "
            f"{q[0.5]:.2e}, p90 {q[0.9]:.2e}, max {rel[-1][0]:.2e} "
            f"({rel[-1][1]}); {len(noise)} biases whose shift BN removes: "
            f"median {noise[len(noise) // 2][0]:.2e}")
        row = {"loss_fused": losses[dtype, True],
               "loss_standard": losses[dtype, False], "loss_rel": dloss,
               "grad_rel_median": q[0.5], "grad_rel_p90": q[0.9],
               "grad_rel_max": rel[-1][0]}
        if dtype == "float32":
            g_loss, g_med, g_p90 = PARITY_F32
            if not (dloss <= g_loss and q[0.5] <= g_med and q[0.9] <= g_p90):
                failed.append(f"float32 parity out of {PARITY_F32}")
        else:
            ref = grads["float32", False]
            qf = _quantiles(_rel_errors(grads[dtype, True], ref, gated))
            qs = _quantiles(_rel_errors(grads[dtype, False], ref, gated))
            log(f"  bfloat16 against the f32 standard gradients: fused "
                f"median {qf[0.5]:.2e} p90 {qf[0.9]:.2e}; standard median "
                f"{qs[0.5]:.2e} p90 {qs[0.9]:.2e}")
            row.update({"vs_f32_fused_median": qf[0.5],
                        "vs_f32_fused_p90": qf[0.9],
                        "vs_f32_standard_median": qs[0.5],
                        "vs_f32_standard_p90": qs[0.9]})
            if not (dloss <= PARITY_BF16_LOSS and all(
                    qf[k] <= PARITY_BF16_RATIO * qs[k] for k in qf)):
                failed.append("bfloat16 parity: the fused path is farther "
                              "from the f32 gradients than the standard "
                              f"path allows ({PARITY_BF16_RATIO}x), or the "
                              f"loss differs by more than {PARITY_BF16_LOSS}")
        result[dtype] = row
    if failed:
        raise AssertionError("; ".join(failed))
    return result


def f64_gaps(sd, crops, targets, grads, gated):
    """Who owns phase 7's f32 gap: the standard model in float64 (cuDNN's
    f64 convolutions, torch's BN) on the same state and batch, and each f32
    path's |g - g64| / |g64| against it, median and p99 over the gated
    tensors. Reported, not gated; a fused median more than three times the
    standard one is a fault of K3/K4's f32 path."""
    import torch
    from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
    from bilinear_tpu_torch.train.hourglass import heatmap_loss

    model = MainModel(dtype=torch.float64).to(torch.float64)
    model.load_state_dict(sd)
    model.to(crops.device).train()
    loss = heatmap_loss(model(crops), targets.double())
    loss.backward()
    ref = {k: p.grad.detach() for k, p in model.named_parameters()
           if p.grad is not None}
    del model, loss
    torch.cuda.empty_cache()
    out = {}
    for fused in (True, False):
        rel = sorted(
            (float((grads["float32", fused][k].double() - ref[k]).norm()
                   / ref[k].norm().clamp_min(1e-300)), k) for k in gated)
        label = "fused" if fused else "standard"
        out[label] = {"median": rel[len(rel) // 2][0],
                      "p99": rel[int(0.99 * (len(rel) - 1))][0]}
        log(f"  float32 {label} vs the standard model in float64: "
            f"|g - g64|/|g64| over {len(rel)} tensors: median "
            f"{out[label]['median']:.2e}, p99 {out[label]['p99']:.2e}, max "
            f"{rel[-1][0]:.2e} ({rel[-1][1]})")
    ratio = out["fused"]["median"] / max(out["standard"]["median"], 1e-300)
    out["fused_over_standard_median"] = ratio
    log(f"  fused / standard median distance from float64: {ratio:.2f}"
        + (" -- the fused f32 path owns the gap (a fault of K3/K4's f32 "
           "path)" if ratio > 3 else ""))
    return out


# ------------------------------------------------------------ phase 8

RES_TIME_SHAPES = ((8, 64, 64, 256, 256), (8, 128, 128, 64, 128))
# The eight full-width shapes of one training step and how many ResModules
# of the detector have each (3 in the stem; per stack 1 at 64x64 and 3 at
# each of 32, 16, 8 and 4, the waist among the last).
RES_STEP_SHAPES = RES_SHAPES[:8]
# Shapes whose calls are also broken down by kernel in the log.
RES_BREAKDOWN_SHAPES = RES_TIME_SHAPES + ((8, 8, 8, 256, 256),)
# Most device kernels one call may launch, the wrapper's own included.
RES_KERNEL_CAPS = {"resmodule_fwd_train": 8, "resmodule_fwd_eval": 4,
                   "resmodule_bwd": 18}
RES_STEP_LAUNCHES = (1, 1, 1, 8, 24, 24, 24, 24)


def res_bound(shape, kind: str, itemsize: int = 2):
    """Least time (ms): ops at the bf16 peak vs bytes at HBM bandwidth.
    Forward (either mode): 2N(Ci Ch + 9 Ch^2 + Ch Co [+ Ci Co]) against
    N (Ci + Co) bytes; backward 4N(...) against N (2 Ci + 2 Co)."""
    b, h, w, ci, co = shape
    n, ch = b * h * w, co // 2
    macs = ci * ch + 9 * ch * ch + ch * co + (ci * co if ci != co else 0)
    if kind == "bwd":
        ops, nbytes = 4 * n * macs, n * (2 * ci + 2 * co) * itemsize
    else:
        ops, nbytes = 2 * n * macs, n * (ci + co) * itemsize
    ops_s, bytes_s = ops / PEAK_BF16, nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _trace(fn, calls: int, pad: float = 0.02):
    """{kernel name: (ms per call, launches per call)} from a
    torch.profiler trace of ``calls`` calls of ``fn``: every device kernel
    and copy, whoever launched it. Annotation ranges, which span kernels
    already counted, are left out: the trainer's own ('train_step/...') and
    the optimizer's ('Optimizer.step#RMSprop.step'); a kernel whose name
    holds a '#' further in (a lambda of an elementwise kernel) is counted.
    One more call runs first, in the profiler's warm-up window: on a busy
    host the tracer comes up late and loses the first launches after its
    start, and records of the warm-up window are discarded anyway. The
    window opens ``pad`` seconds after the warm-up call has finished, the
    recorded calls start ``pad`` seconds after it opens, and it closes
    ``pad`` seconds after the card has finished them: the profiler keeps a
    device record only if it falls inside the window on the host's clock,
    and the card's timestamps, carried over to that clock, can be off by
    some milliseconds either way (the first kernel of the first call, or
    every kernel after it, were lost on torch 2.11; the warm-up call's
    kernels were once counted in, a whole extra call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(pad)
        prof.step()
        time.sleep(pad)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
        prof.step()
    per = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if getattr(evt, "is_user_annotation", False) or \
                evt.key.startswith("train_step/") or \
                evt.key.startswith("ProfilerStep"):
            continue
        if t > 0 and "#" not in evt.key.split("(")[0].split("<")[0]:
            ms, cnt = per.get(evt.key, (0.0, 0.0))
            per[evt.key] = (ms + t / 1e3 / calls, cnt + evt.count / calls)
    return per


def _trace_whole(fn, calls: int):
    """``_trace``, repeated (at most ten times) while the profiler has
    dropped records, as it does now and then on a busy host, sometimes a
    whole trace's: every kernel must show a whole number of launches per
    call, and there must be some. Each attempt doubles the time the window
    is held open around the recorded calls (20 ms, then up to 2.56 s), so
    that a larger offset between the card's clock and the host's still
    falls inside it."""
    for attempt in range(10):
        per = _trace(fn, calls, pad=0.02 * 2 ** min(attempt, 7))
        if per and all(abs(cnt - round(cnt)) < 1e-6 for _, cnt in per.values()):
            return per
        log(f"  trace {attempt + 1} discarded, launches per call not whole: "
            + (", ".join(f"{_short(k)} {cnt:.2f}" for k, (_, cnt)
                         in per.items()) or "no records"))
    raise AssertionError(f"the profiler keeps dropping records: {per}")


def time_resmodule():
    """K3 train, K3 eval and K4 in bf16 at the eight full-width shapes of a
    training step: CUDA-event time of back-to-back calls (kernel, kernel;
    it includes host time where the host is slower than the device), the
    sum of kernel durations and the number of device kernels per call from a
    trace (the wrapper's own casts and copies included), the bound, and the
    launches per training step. At RES_TIME_SHAPES also the plain version
    (plain, kernel, kernel, plain) and the standard ResModule (cuDNN convs +
    torch BN) as a labelled yardstick."""
    import torch
    from bilinear_tpu_torch.models.hourglass_torch7 import ResModule
    from bilinear_tpu_torch.ops import resmodule as rm

    dev = torch.device("cuda")
    dt = torch.bfloat16
    table = {}
    for shape, per_step in zip(RES_STEP_SHAPES, RES_STEP_LAUNCHES):
        x, g, p, stats = res_case(shape, SEED + 40, dev)
        x = x.to(dt)
        g = g.to(dt)
        st = rm._fwd_cuda(x, p, True, None, dt)[1]
        full = shape in RES_TIME_SHAPES
        if full:
            std = ResModule(shape[3], shape[4], dtype=dt).to(dev).train()
            xs = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
            gs = g.permute(0, 3, 1, 2)

            def std_fwd():
                with torch.no_grad():
                    std(xs)

            def std_fwd_bwd():
                torch.autograd.backward(std(xs), gs)

            y_f = cuda_ms(std_fwd, 20)
            y_fb = cuda_ms(std_fwd_bwd, 20)

        cases = {
            "resmodule_fwd_train": (
                "fwd", lambda: rm._fwd_cuda(x, p, True, None, dt),
                lambda: rm.res_block_ref(x, p, train=True, dtype=dt)),
            "resmodule_fwd_eval": (
                "fwd", lambda: rm._fwd_cuda(x, p, False, stats, dt),
                lambda: rm.res_block_ref(x, p, train=False, stats=stats,
                                         dtype=dt)),
            "resmodule_bwd": (
                "bwd", lambda: rm._bwd_cuda(x, g, p, st, dt),
                lambda: rm.res_block_bwd_ref(x, g, p, st, dtype=dt)),
        }
        for name, (kind, kern, plain) in cases.items():
            b_ms, b_by = res_bound(shape, kind)
            p1 = cuda_ms(plain, 5) if full else None
            k1 = cuda_ms(kern, 20)
            k2 = cuda_ms(kern, 20)
            p2 = cuda_ms(plain, 5) if full else None
            per = _trace_whole(kern, 3)
            row = {"ms": (k1 + k2) / 2,
                   "trace_ms": sum(ms for ms, _ in per.values()),
                   "device_kernels_per_call":
                       sum(cnt for _, cnt in per.values()),
                   "launches_per_step": per_step,
                   "bound_ms": b_ms, "bound_by": b_by}
            msg = (f"  {name} {shape} bf16: kernel {row['ms']:.4f} ms by "
                   f"events (turns {k1:.4f}, {k2:.4f}), {row['trace_ms']:.4f} "
                   f"ms as the trace's sum over "
                   f"{row['device_kernels_per_call']:.1f} device kernels per "
                   f"call, bound {b_ms:.4f} ms ({b_by}), {per_step} per "
                   f"training step")
            if full:
                yard = y_f if kind == "fwd" else y_fb - y_f
                row.update({"plain_ms": (p1 + p2) / 2,
                            "yardstick_standard_module_ms": yard})
                msg += (f", plain {row['plain_ms']:.4f} ms, yardstick "
                        f"standard ResModule (cuDNN + torch BN) "
                        f"{'forward' if kind == 'fwd' else 'backward'} "
                        f"{yard:.4f} ms")
            log(msg)
            if shape in RES_BREAKDOWN_SHAPES and name != "resmodule_fwd_eval":
                log("    by kernel, us per call (launches): " + "; ".join(
                    f"{k.split('(')[0].replace('void rm::', '')} "
                    f"{ms * 1e3:.1f} ({cnt:.0f})" for k, (ms, cnt) in
                    sorted(per.items(), key=lambda kv: -kv[1][0])))
            if row["device_kernels_per_call"] > RES_KERNEL_CAPS[name]:
                raise AssertionError(
                    f"{name} {shape}: {row['device_kernels_per_call']} device "
                    f"kernels per call, at most {RES_KERNEL_CAPS[name]}")
            table.setdefault(name, {})[shape] = row
        del x, g, p, stats, st
    for name, rows in table.items():
        by_trace, by_events = (
            sum(r[key] * r["launches_per_step"] for r in rows.values())
            for key in ("trace_ms", "ms"))
        log(f"  {name}: sum over a training step's 107 modules "
            f"{by_trace:.2f} ms by trace, {by_events:.2f} ms by events")
    return table


def time_train_step(data_dir):
    """Full-width training steps (batch 8, bf16), fused and standard:
    ms/step and img/s on one batch and one set of draws, host clock around
    synchronised steps; standard, fused, fused, standard."""
    import torch
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
    from bilinear_tpu_torch.train import hourglass as th

    dev = torch.device("cuda")
    pipe = MPIIHostPipeline(MPIIAnnotations(data_dir, Task.Train),
                            DETECTOR_BATCH, shuffle=True, seed=SEED,
                            transport="u8")
    raw = next(iter(pipe.epoch(1, prefetch=0)))
    states, trainers = {}, {}
    for fused in (True, False):
        trainers[fused] = th.HourglassTrainer(dtype=torch.bfloat16,
                                              fused_blocks=fused, device=dev)
        states[fused] = trainers[fused].init_state(SEED)
    batch = trainers[True].batch_tensors(raw)
    aug = th.sample_augment(th.step_generator(SEED, 1, 1),
                            batch["images"].shape[0])

    def run(fused, steps):
        for _ in range(2):
            trainers[fused].train_step(states[fused], batch, aug)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            trainers[fused].train_step(states[fused], batch, aug)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    turns = [run(False, 5), run(True, 5), run(True, 5), run(False, 5)]
    out = {}
    for fused, ms in ((True, (turns[1] + turns[2]) / 2),
                      (False, (turns[0] + turns[3]) / 2)):
        label = "fused" if fused else "standard"
        busy, n_kernels, top = _device_time(
            lambda: trainers[fused].train_step(states[fused], batch, aug))
        split = host_split(
            lambda: trainers[fused].train_step(states[fused], batch, aug))
        out[label] = {"ms_per_step": ms,
                      "img_per_s": DETECTOR_BATCH * 1e3 / ms,
                      "device_ms_per_step": busy,
                      "device_kernels_per_step": n_kernels,
                      "device_idle_share": max(0.0, 1 - busy / ms),
                      "device_top": top, "host_split_ms": split}
        log(f"  train step {label}: {ms:.2f} ms/step, "
            f"{DETECTOR_BATCH * 1e3 / ms:.1f} img/s (batch {DETECTOR_BATCH},"
            f" bf16, full width; turns {turns}); device busy {busy:.2f} "
            f"ms/step in {n_kernels:.0f} device kernels (idle "
            f"{100 * max(0.0, 1 - busy / ms):.0f}%), top "
            f"kernels ms/step: " + ", ".join(f"{k} {v:.2f}" for k, v in top))
        log(f"  train step {label}: host ms per phase of train_step under the "
            f"profiler, no sync between phases: " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    return out


def _device_time(step, steps: int = 2):
    """Device time and device kernels per step (from a trace of ``steps``
    steps) and the five kernels with the most time, ms per step."""
    per = _trace(step, steps) or _trace(step, steps, pad=0.5)  # all lost
    by_name = {}
    for key, (ms, _) in per.items():
        by_name[key[:60]] = by_name.get(key[:60], 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (sum(ms for ms, _ in per.values()),
            sum(cnt for _, cnt in per.values()), top)


def host_split(step, steps: int = 3):
    """Host milliseconds per phase of the trainer's own train_step, read
    from its record_function ranges (train.hourglass.STEP_RANGES) in a
    torch.profiler trace with CPU activity: what the host spends launching
    each phase, with no synchronisation between phases, and then the wait
    for the device. The profiler's bookkeeping of every operator is inside
    these times, so they sum to more than an unprofiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bilinear_tpu_torch.train.hourglass import STEP_RANGES

    wait = 0.0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            step()
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            wait += (time.perf_counter() - t0) * 1e3 / steps
    ranges = {evt.key: evt for evt in prof.key_averages()}
    split = {}
    for name in STEP_RANGES:
        evt = ranges.get(name)
        if evt is None or evt.count != steps:
            raise AssertionError(f"train_step ran the range {name!r} "
                                 f"{evt.count if evt else 0} times in "
                                 f"{steps} steps")
        split[name.split("/")[1]] = evt.cpu_time_total / 1e3 / steps
    split["device_wait"] = wait
    return split


# ------------------------------------------------------------ phase 9

LIFT_TRAIN_ROWS = 64 * 200 + 37  # 200 whole steps and a 37-row tail
LIFT_VALID_ROWS = 4096
LIFT_TIME_STEPS = 1000


def _log_value(text, prefix, key):
    """Floats after ``key`` on the log lines that hold ``prefix``."""
    return [float(ln.split(key)[1].split(")")[0].split(",")[0])
            for ln in text.splitlines() if prefix in ln]


def drive_lifting_training(work):
    """Train the full-width lifting MLP through cli.train_bilinear (2
    epochs, then 1 more that resumes from 2.save), validate it through
    cli.valid_bilinear, and serve that checkpoint through LiftingServer
    (K1 bf16 and f32): its valid MPJPE must agree with the CLI's. Returns
    ({kernel: K1 launches while serving}, the CLI's MPJPE, {kernel: served
    MPJPE}, losses)."""
    import math

    import torch
    from bilinear_tpu_torch.cli import train_bilinear, valid_bilinear
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
    from bilinear_tpu_torch.eval.mpjpe import evaluate_mpjpe
    from bilinear_tpu_torch.io.checkpoint import load_checkpoint
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.serving import LiftingServer

    data_dir = os.path.join(work, "Human3.6M")
    save_root = os.path.join(work, "save")
    write_h36m_dataset(data_dir, n_train=LIFT_TRAIN_ROWS,
                       n_valid=LIFT_VALID_ROWS, seed=SEED)
    argv = ["--data-dir", data_dir, "--save-root", save_root, "--comment",
            "lift", "--dtype", "bfloat16", "--seed", str(SEED)]
    run_dir = os.path.join(save_root, "lift")
    steps_per_epoch = LIFT_TRAIN_ROWS // 64 + 1
    for epochs in (2, 1):
        t0 = time.perf_counter()
        train_bilinear.main(argv + ["--epochs-per-run", str(epochs)])
        log(f"  cli.train_bilinear --epochs-per-run {epochs}: "
            f"{time.perf_counter() - t0:.1f} s")
    with open(os.path.join(run_dir, "debug.log")) as f:
        text = f.read()
    if "Resumed from epoch 2 (step " not in text:
        raise AssertionError("the second invocation did not resume")
    losses = _log_value(text, "saved (loss:", "loss: ")
    log("  " + "; ".join(ln.split(" > ", 1)[-1] for ln in text.splitlines()
                         if "saved (loss:" in ln or "poses/sec" in ln))
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    payload = load_checkpoint(os.path.join(run_dir, "parameter"), 3)
    count = int(payload["optimizer"]["1"]["count"])
    log(f"  3.save: step {payload['step']}, Adam count {count}; "
        f"{steps_per_epoch} steps per epoch expected (n // 64 + 1)")
    if count != 3 * steps_per_epoch or \
            payload["step"] != 3 * steps_per_epoch + 1:
        raise AssertionError("the steps taken are not 3 epochs of "
                             f"{steps_per_epoch}")

    valid_bilinear.main(argv)
    with open(os.path.join(run_dir, "mpjpe_epoch3.json")) as f:
        cli_mpjpe = json.load(f)["overall"]
    splits = load_h36m(data_dir)
    served, launches = {}, {}
    for name, dtype, tol in (("lifting_bf16", torch.bfloat16, 0.01),
                             ("lifting_f32", torch.float32, 0.001)):
        server, epoch = LiftingServer.from_run_dir(
            run_dir, splits[Task.Train], dtype=dtype)
        pl.LAUNCHES = 0
        _, served[name] = evaluate_mpjpe(server.lift_normalized,
                                         splits[Task.Valid])
        launches[name] = pl.LAUNCHES
        log(f"  served epoch {epoch} through {name}: valid MPJPE "
            f"{served[name]!r} mm, cli.valid_bilinear {cli_mpjpe!r} mm (f32 "
            f"module); {launches[name]} K1 launches")
        if launches[name] == 0:
            raise AssertionError(f"{name}: the kernel was not launched")
        if abs(served[name] - cli_mpjpe) > tol * cli_mpjpe:
            raise AssertionError(f"served {name} MPJPE off the CLI's by more "
                                 f"than {tol:.1%}")
    return launches, cli_mpjpe, served, losses


def time_lifting_training():
    """BilinearTrainer at full width, f32 and bf16: ms/step and poses/s over
    LIFT_TIME_STEPS steps of 64 rows after one warm-up epoch (host clock
    around a synchronised epoch), device-busy ms and device kernels per step
    from a trace of a few steps. Measurements only."""
    import torch
    from bilinear_tpu_torch.train.bilinear import BilinearTrainer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    n = 64 * LIFT_TIME_STEPS
    x = torch.randn((n, IN_F), generator=gen, device=dev)
    y = torch.randn((n, OUT_F), generator=gen, device=dev)
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        trainer = BilinearTrainer(dtype=dtype, device=dev)
        state = trainer.init_state(SEED)
        trainer.train_epoch(state, x[:64 * 100], y[:64 * 100], 1, SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = trainer.train_epoch(state, x, y, 2, SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"{name}: non-finite training loss")
        bx, by = x[:64], y[:64]
        drop = trainer.dropout_generator(SEED, 3)
        busy, kernels, top = _device_time(
            lambda: trainer.train_step(state, bx, by, drop), 5)
        ms = secs * 1e3 / LIFT_TIME_STEPS
        out[name] = {"ms_per_step": ms, "poses_per_s": n / secs,
                     "device_ms_per_step": busy,
                     "device_kernels_per_step": kernels,
                     "device_idle_share": max(0.0, 1 - busy / ms),
                     "device_top": top}
        log(f"  lifting train step {name}: {ms:.4f} ms/step, "
            f"{n / secs:.0f} poses/s over {LIFT_TIME_STEPS} steps of 64; "
            f"device busy {busy:.4f} ms/step in {kernels:.0f} device "
            f"kernels (idle {100 * max(0.0, 1 - busy / ms):.0f}%), top "
            f"kernels ms/step: " + ", ".join(f"{k} {v:.4f}" for k, v in top))
    return out


# ------------------------------------------------------------ phase 10

# Images of phase 6's tree: 14 train records (2 recalibration batches of
# at most 8), 2 valid records (one flip-TTA forward of 16), 2 test rects.
RECAL_BATCHES = 2
PCKH_FORWARDS = 1
EVAL_TIME_CALLS = 10


def _detector_model(run_dir, dtype, fused, dev):
    """The full-width detector of phase 6's 2.save, on the card."""
    from bilinear_tpu_torch.io.checkpoint import load_checkpoint
    from bilinear_tpu_torch.train.hourglass import HourglassTrainer

    state = HourglassTrainer(dtype=dtype, fused_blocks=fused,
                             device=dev).init_state(SEED)
    state.restore(load_checkpoint(os.path.join(run_dir, "parameter"), 2))
    return state.model


def drive_detector_eval(data_dir, work):
    """cli.valid_hourglass on phase 6's 2.save, f32, with --fused-blocks
    true and then false: per-joint PCKh hits within one, and with the fused
    blocks exactly 107 K3-train launches per recalibration batch and 107
    K3-eval launches per PCKh forward (none without). Then
    cli.eval_hourglass twice with the fused blocks: the first writes -1.save,
    the second reuses it; one .txt per test rect, the converter's count the
    exporter's. Returns the launches of the first valid run."""
    from bilinear_tpu_torch.cli import eval_hourglass, valid_hourglass
    from bilinear_tpu_torch.data.mpii import MPIITestAnnotations

    run_dir = os.path.join(work, "save", "smoke")
    argv = ["--data-dir", data_dir, "--save-root", os.path.join(work, "save"),
            "--comment", "smoke", "--batch-size", str(DETECTOR_BATCH),
            "--seed", str(SEED)]
    results, launches = {}, None
    for fused in ("true", "false"):
        _zero_res_counts()
        t0 = time.perf_counter()
        run_cli(valid_hourglass.main, argv + ["--fused-blocks", fused])
        secs = time.perf_counter() - t0
        count = _res_counts()
        with open(os.path.join(run_dir, "pckh_epoch2.json")) as f:
            results[fused] = json.load(f)
        log(f"  cli.valid_hourglass --fused-blocks {fused}: {secs:.1f} s; "
            f"hits {results[fused]['hits']} of {results[fused]['totals']}, "
            f"avg {results[fused]['avg']!r}; launches {count}")
        want = {"resmodule_fwd_train": RES_PER_FORWARD * RECAL_BATCHES,
                "resmodule_fwd_eval": RES_PER_FORWARD * PCKH_FORWARDS,
                "resmodule_bwd": 0} if fused == "true" else \
            dict.fromkeys(count, 0)
        if count != want:
            raise AssertionError(f"launches {count}, expected {want}")
        if fused == "true":
            launches = count
    a, b = results["true"], results["false"]
    if a["totals"] != b["totals"] or any(
            abs(x - y) > 1 for x, y in zip(a["hits"], b["hits"])):
        raise AssertionError("fused and standard PCKh hits differ by more "
                             "than one per joint")

    parameter_dir = os.path.join(run_dir, "parameter")
    n_rects = len(MPIITestAnnotations(data_dir))
    for invocation in (1, 2):
        _zero_res_counts()
        run_cli(eval_hourglass.main, argv + ["--fused-blocks", "true"])
        count = _res_counts()
        export_forwards = -(-n_rects // DETECTOR_BATCH)
        want = {"resmodule_fwd_train":
                RES_PER_FORWARD * RECAL_BATCHES if invocation == 1 else 0,
                "resmodule_fwd_eval": RES_PER_FORWARD * export_forwards,
                "resmodule_bwd": 0}
        log(f"  cli.eval_hourglass invocation {invocation}: launches {count}")
        if count != want:
            raise AssertionError(f"launches {count}, expected {want}")
        if not os.path.exists(os.path.join(parameter_dir, "-1.save")):
            raise AssertionError("-1.save was not written")
    with open(os.path.join(run_dir, "debug.log")) as f:
        text = f.read()
    if text.count("Finalizing BN statistics") != 1 or \
            text.count("Using finalized BN statistics (-1.save)") != 1:
        raise AssertionError("-1.save was not written once and reused once")
    files = os.listdir(os.path.join(run_dir, "prediction"))
    injected = [ln.split(" > ", 1)[-1] for ln in text.splitlines()
                if "Converter injected" in ln]
    log(f"  -1.save written once and reused; {len(files)} prediction files "
        f"for {n_rects} test rects; {injected[-1]}")
    if len(files) != n_rects or \
            f"Converter injected {n_rects} rects" not in injected[-1] or \
            not os.path.exists(os.path.join(run_dir,
                                            "pred_keypoints_mpii.mat")):
        raise AssertionError("the export or the converter is incomplete")
    return launches


def detector_eval_parity(data_dir, work):
    """The recalibrated statistics and the batch-16 flip-TTA heatmaps of the
    fused model against the standard one, f32, from phase 6's 2.save: the
    two compute the same function in another order (statistics within
    1e-3 relative, heatmaps' mean |d| within 1e-4 of mean |ref|)."""
    import torch
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
    from bilinear_tpu_torch.eval.recalibrate import recalibrate
    from bilinear_tpu_torch.ops.affine import hflip
    from bilinear_tpu_torch.train.hourglass import batch_tensors, \
        preprocess_batch

    dev = torch.device("cuda")
    run_dir = os.path.join(work, "save", "smoke")
    valid = next(iter(MPIIHostPipeline(
        MPIIAnnotations(data_dir, Task.Valid), DETECTOR_BATCH, pad=True)
        .epoch(0, prefetch=0)))
    b = batch_tensors(valid, dev)
    crops = preprocess_batch(b["images"], b["centers"], b["scales"],
                             b["keypoints"], b["valid"], None)[0]
    both = torch.cat([crops, hflip(crops)])
    buffers, heat = {}, {}
    for fused in (True, False):
        model = _detector_model(run_dir, torch.float32, fused, dev)
        recalibrate(model, MPIIHostPipeline(
            MPIIAnnotations(data_dir, Task.Train), DETECTOR_BATCH, pad=True))
        buffers[fused] = {k: v.clone() for k, v in model.named_buffers()}
        with torch.no_grad():
            heat[fused] = model.eval()(both)[-1]
        del model
        torch.cuda.empty_cache()
    worst = 0.0
    for k, ref in buffers[False].items():
        got = buffers[True][k]
        if k.endswith("num_batches_tracked"):
            if int(got) != int(ref) or int(ref) != RECAL_BATCHES:
                raise AssertionError(f"{k}: {int(got)} fused, {int(ref)} "
                                     f"standard")
        else:
            worst = max(worst, float(((got - ref).abs()
                                      / ref.abs().clamp_min(1e-2)).max()))
    log(f"  f32 recalibration, fused vs standard: max rel diff {worst:.2e} "
        f"over {len(buffers[False])} buffers")
    if worst > 1e-3:
        raise AssertionError("the recalibrated statistics disagree")
    gate_close("f32 flip-TTA heatmaps at batch 16, fused vs standard",
               heat[True], heat[False], 1e-4)
    return worst


def time_detector_eval(data_dir, work):
    """bf16, fused and standard, on device-resident batches (the host
    pipeline not timed): img/s of the recalibration forward (train mode,
    no_grad, cumulative BN) at batch 8 and of the flip-TTA PCKh step at
    batch 8 (one forward of 16); device-busy ms and device kernels per call
    from a trace. Measurements only."""
    import torch
    from bilinear_tpu_torch.core.norm import cumulative_momentum
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
    from bilinear_tpu_torch.eval.pckh import pckh_counts
    from bilinear_tpu_torch.train.hourglass import batch_tensors, \
        preprocess_batch

    dev = torch.device("cuda")
    run_dir = os.path.join(work, "save", "smoke")
    batch = next(iter(MPIIHostPipeline(
        MPIIAnnotations(data_dir, Task.Valid), DETECTOR_BATCH, pad=True)
        .epoch(0, prefetch=0)))
    b = batch_tensors(batch, dev)
    crops = preprocess_batch(b["images"], b["centers"], b["scales"],
                             b["keypoints"], b["valid"], None)[0]
    heads = torch.from_numpy(batch.heads).to(dev)
    real = torch.from_numpy(batch.index >= 0).to(dev)
    out = {}
    for fused in (True, False):
        model = _detector_model(run_dir, torch.bfloat16, fused, dev)

        @torch.no_grad()
        def recal():
            model(crops)

        def pckh():
            pckh_counts(model, b, heads, real)

        row = {}
        with cumulative_momentum(model):
            for name, fn, train in (("recalibration", recal, True),
                                    ("pckh", pckh, False)):
                model.train(train)
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(EVAL_TIME_CALLS):
                    fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / EVAL_TIME_CALLS
                busy, kernels, top = _device_time(fn, 2)
                row[name] = {"ms_per_batch": ms,
                             "img_per_s": DETECTOR_BATCH * 1e3 / ms,
                             "device_ms_per_call": busy,
                             "device_kernels_per_call": kernels,
                             "device_top": top}
                log(f"  {'fused' if fused else 'standard'} {name}, bf16, "
                    f"batch {DETECTOR_BATCH}"
                    f"{' (one forward of 16)' if name == 'pckh' else ''}: "
                    f"{ms:.2f} ms, {DETECTOR_BATCH * 1e3 / ms:.1f} img/s; "
                    f"device busy {busy:.2f} ms in {kernels:.0f} device "
                    f"kernels per call; top ms: "
                    + ", ".join(f"{k} {v:.2f}" for k, v in top))
        out["fused" if fused else "standard"] = row
        del model
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 11

# Phase 11's H36M tree: 24 train frames (3 FT steps of 8 per epoch) and 8
# valid frames; an export forward is one batch of 8, so one conversion runs
# 3 + 1 forwards.
FT_TRAIN, FT_VALID = 24, 8
FT_STEPS = -(-FT_TRAIN // DETECTOR_BATCH)
SH_FORWARDS = FT_STEPS + -(-FT_VALID // DETECTOR_BATCH)
# The full-width preact model's f32 gradients against its float64 ones on
# the card: the median over gated tensors of |g32 - g64| / |g64| may be at
# most this many times that of the same model with cuDNN's batch norm.
FT_PARITY_RATIO = 1.5
FT_TIME_STEPS = 5


def run_cli(main, argv):
    """``main(argv)`` started from torch's default precision switches
    (cuDNN convolutions in TF32, matmuls in f32); the CLI must leave TF32
    off for both."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    main(argv)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError(f"{main.__module__} left TF32 on")


def _bins(data_dir, protocol):
    import pickle

    out = {}
    for task in ("train", "valid"):
        with open(os.path.join(data_dir, f"{task}_{protocol}.bin"),
                  "rb") as f:
            out[task] = pickle.load(f)
    return out


def _check_sh_bins(data_dir, protocol):
    """Both bins of ``protocol``: the GT bins' keys, every key but ``part``
    the GT bins' values, ``part`` finite (N, 17, 2) detections."""
    import numpy as np

    got, gt = _bins(data_dir, protocol), _bins(data_dir, "GT")
    for task in ("train", "valid"):
        if got[task].keys() != gt[task].keys():
            raise AssertionError(f"{task}_{protocol}.bin: keys differ")
        for key, ref in gt[task].items():
            if key == "part":
                continue
            if len(got[task][key]) != len(ref) or not all(
                    np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(got[task][key], ref)):
                raise AssertionError(f"{task}_{protocol}.bin: {key} is not "
                                     f"the GT bin's")
        part = np.stack(got[task]["part"])
        if part.shape != (len(ref), 17, 2) or not np.isfinite(part).all():
            raise AssertionError(f"{task}_{protocol}.bin: part {part.shape}")
    return got


def drive_ft(work):
    """The slice of phase 11 through its CLIs, each from torch's default
    precision switches: cli.train_hourglass_ft at full width in f32 for one
    epoch and once more (resumes, writes 2.save), cli.valid_hourglass_ft,
    cli.sh_preprocess --variant preact --protocol-out SH+FT, cli.sh_preprocess
    --variant torch7 on phase 6's 2.save with --fused-blocks true (exactly
    107 K3-eval launches per export forward) and false (none), the two
    conversions' detections against each other, then cli.train_bilinear
    --protocol SH+FT for one epoch and cli.valid_bilinear. Returns a record
    and the fused conversion's launches."""
    import math

    import numpy as np
    from bilinear_tpu_torch.cli import (sh_preprocess, train_bilinear,
                                        train_hourglass_ft, valid_bilinear,
                                        valid_hourglass_ft)
    from bilinear_tpu_torch.data.synthetic import write_h36m_dataset
    from bilinear_tpu_torch.io.checkpoint import load_checkpoint

    data_dir = os.path.join(work, "Human3.6M")
    save_root = os.path.join(work, "save")
    write_h36m_dataset(data_dir, n_train=FT_TRAIN, n_valid=FT_VALID,
                       with_images=True, seed=SEED)
    run_dir = os.path.join(save_root, "Hourglass FT")
    ft = ["--data-dir", data_dir, "--save-root", save_root, "--batch-size",
          str(DETECTOR_BATCH), "--seed", str(SEED)]
    for invocation in (1, 2):
        t0 = time.perf_counter()
        run_cli(train_hourglass_ft.main, ft + ["--epochs-per-run", "1"])
        log(f"  cli.train_hourglass_ft invocation {invocation}: "
            f"{FT_TRAIN} frames, {FT_STEPS} steps of {DETECTOR_BATCH}, f32, "
            f"full width: {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(run_dir, "debug.log")) as f:
        text = f.read()
    losses = _log_value(text, "saved (loss:", "loss: ")
    log("  " + "; ".join(ln.split(" > ", 1)[-1] for ln in text.splitlines()
                         if "saved (loss:" in ln))
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"FT losses {losses}")
    if f"Resumed from epoch 1 (step {FT_STEPS + 1})" not in text:
        raise AssertionError("the second FT invocation did not resume")
    payload = load_checkpoint(os.path.join(run_dir, "parameter"), 2)
    count = int(payload["optimizer"]["1"]["count"])
    log(f"  2.save: step {payload['step']}, RMSprop count {count}")
    if payload["step"] != 2 * FT_STEPS + 1 or count != 2 * FT_STEPS:
        raise AssertionError(f"2.save's counters are not those of 2 epochs "
                             f"of {FT_STEPS} steps")

    t0 = time.perf_counter()
    run_cli(valid_hourglass_ft.main, ft)
    with open(os.path.join(run_dir, "pckh_ft_epoch2.json")) as f:
        pckh = json.load(f)
    log(f"  cli.valid_hourglass_ft: {time.perf_counter() - t0:.1f} s; "
        f"PCKh avg {pckh['avg']!r}, hits {pckh['hits']} of "
        f"{pckh['totals']}")
    if pckh["epoch"] != 2 or not math.isfinite(pckh["avg"]):
        raise AssertionError("pckh_ft_epoch2.json")

    sh = ["--h36m-dir", data_dir, "--save-root", save_root, "--batch-size",
          str(DETECTOR_BATCH), "--seed", str(SEED)]
    t0 = time.perf_counter()
    _zero_res_counts()
    run_cli(sh_preprocess.main, sh + ["--comment", "Hourglass FT",
                                      "--variant", "preact",
                                      "--protocol-out", "SH+FT"])
    if any(_res_counts().values()):
        raise AssertionError("the preact conversion launched K3/K4")
    _check_sh_bins(data_dir, "SH+FT")
    log(f"  cli.sh_preprocess --variant preact --protocol-out SH+FT: "
        f"{time.perf_counter() - t0:.1f} s; both bins equal the GT bins but "
        f"for part")

    counts = {}
    for fused, proto in (("true", "SH"), ("false", "SH-standard")):
        _zero_res_counts()
        t0 = time.perf_counter()
        run_cli(sh_preprocess.main, sh + ["--comment", "smoke", "--variant",
                                          "torch7", "--fused-blocks", fused,
                                          "--protocol-out", proto])
        counts[fused] = _res_counts()
        want = {"resmodule_fwd_train": 0, "resmodule_bwd": 0,
                "resmodule_fwd_eval": RES_PER_FORWARD * SH_FORWARDS
                if fused == "true" else 0}
        log(f"  cli.sh_preprocess --variant torch7 --fused-blocks {fused} "
            f"(phase 6's 2.save): {time.perf_counter() - t0:.1f} s; "
            f"{SH_FORWARDS} export forwards; launches {counts[fused]}")
        if counts[fused] != want:
            raise AssertionError(f"launches {counts[fused]}, expected {want}")
    fused_bins = _check_sh_bins(data_dir, "SH")
    std_bins = _check_sh_bins(data_dir, "SH-standard")
    agree = []
    for task in ("train", "valid"):
        a = np.stack(fused_bins[task]["part"])
        b = np.stack(std_bins[task]["part"])
        cell = 200 * np.asarray(std_bins[task]["scale"], np.float64)[:, None] \
            / 64
        dist = np.linalg.norm(a - b, axis=-1)
        agree.append(float((dist <= 1e-3 * cell).mean()))
        if agree[-1] < 0.95 or not (dist <= cell * (1 + 1e-6)).all():
            raise AssertionError(f"{task}: fused and standard SH detections "
                                 f"disagree ({agree[-1]:.3f} equal, max "
                                 f"{float((dist / cell).max()):.2f} cells)")
    log(f"  SH detections, fused vs standard: share of joints equal "
        f"(train, valid) {agree}, none more than one heatmap cell apart")

    bl = ["--data-dir", data_dir, "--protocol", "SH+FT", "--comment",
          "Bilinear SH+FT", "--save-root", save_root, "--seed", str(SEED)]
    run_cli(train_bilinear.main, bl + ["--epochs-per-run", "1"])
    run_cli(valid_bilinear.main, bl)
    with open(os.path.join(save_root, "Bilinear SH+FT",
                           "mpjpe_epoch1.json")) as f:
        mpjpe = json.load(f)["overall"]
    log(f"  cli.train_bilinear --protocol SH+FT (1 epoch) then "
        f"cli.valid_bilinear: MPJPE {mpjpe!r} mm")
    if not math.isfinite(mpjpe):
        raise AssertionError("the SH+FT lifter's MPJPE is not finite")
    return {"losses": losses, "pckh_ft_avg": pckh["avg"],
            "sh_fused_vs_standard_equal_share": agree,
            "sh_ft_mpjpe_mm": mpjpe}, counts["true"]


def _ft_batch(data_dir, dev, task="train"):
    """One H36M batch of 8 as device tensors, the step's draws (no flip)."""
    from bilinear_tpu_torch.data.h36m import load_h36m
    from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
    from bilinear_tpu_torch.train import hourglass as th

    records = H36MImageRecords(load_h36m(data_dir)[task], data_dir)
    pipe = MPIIHostPipeline(records, DETECTOR_BATCH, shuffle=True, seed=SEED,
                            transport="u8")
    b = th.batch_tensors(next(iter(pipe.epoch(1, prefetch=0))), dev)
    aug = th.sample_augment(th.step_generator(SEED, 1, 1),
                            b["images"].shape[0], flip_prob=0.0)
    return b, aug


def _cudnn_bn(model):
    """``model`` with every BN's train-mode normalisation done by
    ``F.batch_norm`` (cuDNN's fused batch norm and its backward) instead of
    core.norm.BatchNorm2d's own: a second f32 implementation of the same
    function (its running statistics are left alone)."""
    import types

    import torch.nn.functional as F
    from bilinear_tpu_torch.core.norm import BatchNorm2d

    def forward(bn, x):
        return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                            bn.eps)

    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.forward = types.MethodType(forward, m)
    return model


def ft_parity(data_dir):
    """The full-width preact model's train-mode heatmaps and FT-loss
    gradients in f32 against the same model in float64 on the card, from
    one state on one batch, beside the same f32 model with cuDNN's batch
    norm (``_cudnn_bn``) as a yardstick. Per tensor |g32 - g64| / |g64|:
    the port's median must be at most FT_PARITY_RATIO times the
    yardstick's. A ResUnit's skip-conv bias only shifts channels that the
    heads' train-mode BNs remove (zero gradient in exact arithmetic) and the
    last stack's after/skip heads feed no output: those are left out."""
    import torch
    from bilinear_tpu_torch.models.hourglass import StackedHourglass
    from bilinear_tpu_torch.ops.joints import FROM_H36M_TO_MPII
    from bilinear_tpu_torch.train import hourglass as th

    dev = torch.device("cuda")
    b, aug = _ft_batch(data_dir, dev)
    crops, targets, _ = th.preprocess_batch(
        b["images"], b["centers"], b["scales"], b["keypoints"], b["valid"],
        aug)
    targets = targets[:, torch.as_tensor(FROM_H36M_TO_MPII, dtype=torch.long,
                                         device=dev)]
    sd = StackedHourglass(generator=torch.Generator().manual_seed(SEED)) \
        .state_dict()
    heat, grads, losses = {}, {}, {}
    for label, dtype in (("float64", torch.float64),
                         ("float32", torch.float32),
                         ("float32_cudnn_bn", torch.float32)):
        model = StackedHourglass(dtype=dtype).to(dtype)
        model.load_state_dict(sd)
        if label.endswith("cudnn_bn"):
            _cudnn_bn(model)
        model.to(dev).train()
        out = model(crops.to(dtype))
        loss = th.heatmap_loss(out, targets.to(dtype))
        loss.backward()
        heat[label] = out.detach().double()
        losses[label] = float(loss.detach())
        grads[label] = {k: p.grad.detach().double()
                        for k, p in model.named_parameters()
                        if p.grad is not None}
        del model, out, loss
        torch.cuda.empty_cache()
    ref = grads["float64"]
    gated = [k for k in ref if not k.endswith(".skip.bias")
             and float(ref[k].norm()) > 0]
    result = {}
    for label in ("float32", "float32_cudnn_bn"):
        rel = sorted((float((grads[label][k] - ref[k]).norm()
                            / ref[k].norm()), k) for k in gated)
        row = {"loss_rel": abs(losses[label] - losses["float64"])
               / abs(losses["float64"]),
               "heatmap_max_rel": float((heat[label] - heat["float64"]).abs()
                                        .max() / heat["float64"].abs().max()),
               "grad_rel_median": rel[len(rel) // 2][0],
               "grad_rel_p99": rel[int(0.99 * (len(rel) - 1))][0],
               "grad_rel_max": rel[-1][0]}
        result[label] = row
        log(f"  preact {label} vs float64, full width, batch "
            f"{DETECTOR_BATCH}: loss rel {row['loss_rel']:.2e}; heatmaps "
            f"max|d| / max|ref| {row['heatmap_max_rel']:.2e}; |g32 - g64| / "
            f"|g64| over {len(rel)} tensors: median "
            f"{row['grad_rel_median']:.2e}, p99 {row['grad_rel_p99']:.2e}, "
            f"max {rel[-1][0]:.2e} ({rel[-1][1]})")
    ratio = result["float32"]["grad_rel_median"] / \
        result["float32_cudnn_bn"]["grad_rel_median"]
    result["median_over_yardstick"] = ratio
    log(f"  the port's median over the cuDNN-BN yardstick's: {ratio:.2f}")
    if not ratio <= FT_PARITY_RATIO:
        raise AssertionError(f"preact f32 gradients {ratio:.2f} times as far "
                             f"from float64 as the yardstick's")
    return result


# What makes the host wait for the card: a scalar fetched, a synchronous
# copy, a sync (a copy from the card into pageable memory synchronises the
# stream). An asynchronous copy alone (a device-to-device copy_) does not.
HOST_READS = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpy")


def _host_reads(fn, inside: str):
    """Names of host reads of the card (a scalar fetched, a copy, a sync)
    that ``fn`` issues inside its profiler range ``inside``, from a trace
    with CPU and CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = [e.time_range for e in events if e.name == inside]
    if not spans:
        raise AssertionError(f"no {inside!r} range in the trace")
    return sorted({e.name for e in events if e.name in HOST_READS
                   and any(s.start <= e.time_range.start <= s.end
                           for s in spans)})


def _in_range(fn, *args):
    from torch.profiler import record_function

    with record_function("control"):
        fn(*args)


def time_ft(data_dir, work):
    """Measurements of phase 11, no gate but the host-read check: the FT
    step (batch 8, full width, f32 and bf16: ms/step, img/s, device-busy ms
    and kernels per step); that the f32 step's forward reads nothing from
    the card on the host (checked against torch's own cumulative BN, which
    must show a read); the recalibration forward of cli.valid_hourglass_ft
    (f32, train mode under no_grad, cumulative BN) and the SH export forward
    (f32): torch7 fused and standard from phase 6's 2.save, and preact from
    the FT 2.save, each on one device-resident batch of 8."""
    import torch
    from bilinear_tpu_torch.core.norm import cumulative_momentum
    from bilinear_tpu_torch.eval.mpii_test_export import export_heatmap_poses
    from bilinear_tpu_torch.io.checkpoint import load_checkpoint
    from bilinear_tpu_torch.ops.joints import FROM_H36M_TO_MPII
    from bilinear_tpu_torch.train import hourglass as th

    dev = torch.device("cuda")
    b, aug = _ft_batch(data_dir, dev)
    out = {"train_step": {}}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        trainer = th.HourglassTrainer(
            variant="preact", dtype=dtype, device=dev, flip_prob=0.0,
            joint_remap=FROM_H36M_TO_MPII)
        state = trainer.init_state(SEED)

        def step():
            trainer.train_step(state, b, aug)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FT_TIME_STEPS):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / FT_TIME_STEPS
        busy, kernels, top = _device_time(step)
        out["train_step"][name] = {
            "ms_per_step": ms, "img_per_s": DETECTOR_BATCH * 1e3 / ms,
            "device_ms_per_step": busy, "device_kernels_per_step": kernels,
            "device_idle_share": max(0.0, 1 - busy / ms), "device_top": top}
        log(f"  FT step (preact) {name}: {ms:.2f} ms/step, "
            f"{DETECTOR_BATCH * 1e3 / ms:.1f} img/s (batch {DETECTOR_BATCH}, "
            f"full width); device busy {busy:.2f} ms/step in {kernels:.0f} "
            f"device kernels (idle {100 * max(0.0, 1 - busy / ms):.0f}%), "
            f"top kernels ms/step: "
            + ", ".join(f"{k} {v:.2f}" for k, v in top))
        if name == "float32":
            reads = _host_reads(step, th.STEP_RANGES[1])
            bn = torch.nn.BatchNorm2d(256, momentum=None).to(dev).train()
            x = torch.randn(8, 256, 64, 64, device=dev)
            control = _host_reads(lambda: _in_range(bn, x), "control")
            log(f"  host reads inside {th.STEP_RANGES[1]} of an f32 FT step: "
                f"{reads or 'none'}; torch's BatchNorm2d(momentum=None) "
                f"shows {control}")
            if reads:
                raise AssertionError(f"the FT forward reads the card on the "
                                     f"host: {reads}")
            if "aten::_local_scalar_dense" not in control:
                raise AssertionError("the host-read check does not see "
                                     "torch's cumulative BN read")
            out["host_reads_in_forward"] = reads
        del trainer, state
        torch.cuda.empty_cache()

    crops = th.preprocess_batch(b["images"], b["centers"], b["scales"],
                                b["keypoints"], b["valid"], None)[0]
    models = {}
    for label, variant, fused, run in (
            ("torch7_fused", "torch7", True, "smoke"),
            ("torch7_standard", "torch7", False, "smoke"),
            ("preact", "preact", False, "Hourglass FT")):
        state = th.HourglassTrainer(variant=variant, fused_blocks=fused,
                                    device=dev).init_state(SEED)
        state.restore(load_checkpoint(os.path.join(work, "save", run,
                                                   "parameter"), 2))
        models[label] = state.model
    passes = [("recalibration_preact", models["preact"], True)] + [
        (f"sh_export_{k}", m, False) for k, m in models.items()]
    out["passes"] = {}
    for name, model, train in passes:
        model.train(train)

        @torch.no_grad()
        def fn():
            if train:
                model(crops)
            else:
                export_heatmap_poses(model, b)

        with cumulative_momentum(model):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EVAL_TIME_CALLS):
                fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / EVAL_TIME_CALLS
            busy, kernels, top = _device_time(fn, 2)
        out["passes"][name] = {
            "ms_per_batch": ms, "img_per_s": DETECTOR_BATCH * 1e3 / ms,
            "device_ms_per_call": busy, "device_kernels_per_call": kernels,
            "device_top": top}
        log(f"  {name}, f32, batch {DETECTOR_BATCH}: {ms:.2f} ms, "
            f"{DETECTOR_BATCH * 1e3 / ms:.1f} img/s; device busy {busy:.2f} "
            f"ms in {kernels:.0f} device kernels per call; top ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in top))
    return out


# ------------------------------------------------------------ phase 12

# Phase 12 runs on phase 11's H36M tree (24 train frames: 3 steps of 8 per
# epoch, drop_last; 8 valid frames: one evaluation batch).
E2E_STEPS = FT_TRAIN // DETECTOR_BATCH
E2E_VALID_BATCHES = -(-FT_VALID // DETECTOR_BATCH)
E2E_WEBCAM_FRAMES = 4
E2E_LR = "2.5e-5"  # a warm start needs it (RMSprop's first ~10 lr sign(g))
# /v1/pose requests: (frames, frame dtype); the two of MIXED go together.
POSE_REQUESTS = ((1, "uint8"), (5, "float32"), (8, "uint8"), (16, "float32"),
                 (21, "uint8"), (21, "float32"), (8, "float32"))
POSE_MIXED = ((3, "uint8"), (6, "float32"))
# Served (fused, K3 eval, bf16) against the plain End2End forward (cuDNN)
# on the same weights and frames. In bf16 the two round at other points
# through 8 stacks, and the x10 soft-argmax of the heatmaps of a barely
# trained detector turns that into pixels. So, as phase 7 holds bf16
# gradients, both bf16 paths are held against the plain path in f32, and
# the served answers may be at most POSE_BF16_RATIO times as far from it as
# the plain bf16 ones (median and p90 of the per-joint distance over every
# frame served): pose2d in pixels, pose3d in mm. A planted K3 fault must
# fail this gate on the same frames.
POSE_BF16_RATIO = 1.5
# Served against End2EndServer.predict called directly (the same kernels,
# without HTTP and the batcher): rounding of row position only.
POSE_SELF_GATE = 1e-3
E2E_VALID_AGREE = 1e-3  # fused vs standard valid MPJPE, relative
# BN buffers after one f32 step, fused vs standard: the detector's at phase
# 7's gate; the lifter's BNs average inputs decoded by the x10 soft-argmax
# from heatmaps that agree to ~1e-6, which moves them more (1.9e-4 at
# worst over both halves on an NVIDIA H100 80GB HBM3 at 700 W, from halves at
# random initialisation).
E2E_BN_GATES = {"hourglass": 1e-4, "bilinear": 1e-3}
E2E_TIME_STEPS = 5
POSE_TIME_SIZES = (1, 8, 16)
POSE_TIME_CALLS = 20


def _lift_counts():
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq

    return pl.LAUNCHES, pq.LAUNCHES


def drive_e2e_training(work, lift_parameter_dir):
    """cli.train_end2end --variant torch7 --fused-blocks true at full width
    in f32 on phase 11's H36M tree, warm-started from phase 6's torch7
    2.save (under save/Hourglass) and phase 9's lifting 3.save (under
    save/Bilinear GT), then once more (resume, 2.save): finite losses,
    exactly 107 K3-train and 107 K4 launches per step, no K3-eval, K1 or
    K2 launch. Returns (launches, losses)."""
    import math

    from bilinear_tpu_torch.cli import train_end2end
    from bilinear_tpu_torch.io.checkpoint import load_checkpoint

    data_dir = os.path.join(work, "Human3.6M")
    save_root = os.path.join(work, "save")
    shutil.copytree(os.path.join(save_root, "smoke", "parameter"),
                    os.path.join(save_root, "Hourglass", "parameter"))
    shutil.copytree(lift_parameter_dir,
                    os.path.join(save_root, "Bilinear GT", "parameter"))
    argv = ["--data-dir", data_dir, "--save-root", save_root, "--variant",
            "torch7", "--fused-blocks", "true", "--learning-rate", E2E_LR,
            "--batch-size", str(DETECTOR_BATCH), "--seed", str(SEED),
            "--epochs-per-run", "1"]
    run_dir = os.path.join(save_root, "End2End")
    launches = {k: 0 for k in _res_counts()}
    for invocation in (1, 2):
        _zero_res_counts()
        lift_before = _lift_counts()
        t0 = time.perf_counter()
        run_cli(train_end2end.main, argv)
        count = _res_counts()
        log(f"  cli.train_end2end invocation {invocation}: {E2E_STEPS} "
            f"steps of {DETECTOR_BATCH}, f32, fused, full width: "
            f"{time.perf_counter() - t0:.1f} s; launches {count}")
        want = {"resmodule_fwd_train": RES_PER_FORWARD * E2E_STEPS,
                "resmodule_bwd": RES_PER_FORWARD * E2E_STEPS,
                "resmodule_fwd_eval": 0}
        if count != want:
            raise AssertionError(f"launches {count}, expected {want}")
        if _lift_counts() != lift_before:
            raise AssertionError("End2End training launched K1/K2")
        for k, v in count.items():
            launches[k] += v
    with open(os.path.join(run_dir, "debug.log")) as f:
        text = f.read()
    for half, run in (("hourglass", "Hourglass"),
                      ("bilinear", "Bilinear GT")):
        if f"Warm-started {half} from {os.path.join(save_root, run)}" \
                not in text:
            raise AssertionError(f"the {half} half was not warm-started")
    if f"Resumed from epoch 1 (step {E2E_STEPS + 1})" not in text:
        raise AssertionError("the second invocation did not resume")
    lines = [ln.split(" > ", 1)[-1] for ln in text.splitlines()
             if " saved (loss " in ln]
    losses = [float(ln.split("(loss ")[1].split(" ")[0]) for ln in lines]
    log("  " + "; ".join(lines))
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"End2End losses {losses}")
    payload = load_checkpoint(os.path.join(run_dir, "parameter"), 2)
    count = int(payload["optimizer"]["1"]["count"])
    log(f"  both halves warm-started, resumed; 2.save: step "
        f"{payload['step']}, RMSprop count {count}")
    if payload["step"] != 2 * E2E_STEPS + 1 or count != 2 * E2E_STEPS:
        raise AssertionError("2.save's counters are not 2 epochs of "
                             f"{E2E_STEPS} steps")
    return launches, losses


def drive_e2e_eval(work):
    """cli.valid_end2end on the End2End 2.save with --fused-blocks true
    (exactly 107 K3-eval launches per batch) and false (none), MPJPE within
    E2E_VALID_AGREE of each other; the CLI on a run with no checkpoint must
    stop with its error; cli.webcam --synthetic --frames 4 writes 4 PNGs
    (107 K3-eval launches per frame). Returns (launches, record)."""
    import math

    from bilinear_tpu_torch.cli import valid_end2end, webcam

    data_dir = os.path.join(work, "Human3.6M")
    save_root = os.path.join(work, "save")
    argv = ["--data-dir", data_dir, "--save-root", save_root, "--variant",
            "torch7", "--batch-size", str(DETECTOR_BATCH), "--seed",
            str(SEED)]
    mpjpe, launches = {}, {k: 0 for k in _res_counts()}
    for fused in ("true", "false"):
        _zero_res_counts()
        t0 = time.perf_counter()
        run_cli(valid_end2end.main, argv + ["--fused-blocks", fused])
        count = _res_counts()
        with open(os.path.join(save_root, "End2End",
                               "mpjpe_e2e_epoch2.json")) as f:
            mpjpe[fused] = json.load(f)["overall"]
        log(f"  cli.valid_end2end --fused-blocks {fused}: "
            f"{time.perf_counter() - t0:.1f} s; MPJPE {mpjpe[fused]!r} mm; "
            f"launches {count}")
        want = {"resmodule_fwd_train": 0, "resmodule_bwd": 0,
                "resmodule_fwd_eval": RES_PER_FORWARD * E2E_VALID_BATCHES
                if fused == "true" else 0}
        if count != want:
            raise AssertionError(f"launches {count}, expected {want}")
        if not math.isfinite(mpjpe[fused]):
            raise AssertionError("the End2End MPJPE is not finite")
        if fused == "true":
            launches = count
    rel = abs(mpjpe["true"] - mpjpe["false"]) / mpjpe["false"]
    log(f"  valid MPJPE fused vs standard: rel {rel:.2e} (gate "
        f"{E2E_VALID_AGREE})")
    if rel > E2E_VALID_AGREE:
        raise AssertionError("fused and standard End2End MPJPE disagree")

    try:
        run_cli(valid_end2end.main, argv + ["--comment", "no checkpoint"])
    except SystemExit as e:
        if "no checkpoint under" not in str(e):
            raise
        log(f"  cli.valid_end2end on a run with no checkpoint stopped: {e}")
    else:
        raise AssertionError("valid_end2end evaluated a run with no "
                             "checkpoint")

    out_dir = os.path.join(work, "webcam")
    _zero_res_counts()
    t0 = time.perf_counter()
    run_cli(webcam.main, ["--synthetic", "--frames", str(E2E_WEBCAM_FRAMES),
                          "--out-dir", out_dir, "--save-root", save_root,
                          "--variant", "torch7"])
    count = _res_counts()
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    log(f"  cli.webcam --synthetic --frames {E2E_WEBCAM_FRAMES}: "
        f"{time.perf_counter() - t0:.1f} s; {len(pngs)} PNGs; launches "
        f"{count}")
    if len(pngs) != E2E_WEBCAM_FRAMES:
        raise AssertionError(f"webcam wrote {pngs}")
    if count["resmodule_fwd_eval"] != RES_PER_FORWARD * E2E_WEBCAM_FRAMES:
        raise AssertionError(f"webcam launches {count}")
    launches["resmodule_fwd_eval"] += count["resmodule_fwd_eval"]
    return launches, {"mpjpe_fused": mpjpe["true"],
                      "mpjpe_standard": mpjpe["false"], "mpjpe_rel": rel}


def _pose_frames(n, seed):
    import numpy as np

    return np.random.RandomState(seed).randint(0, 256, (n, 256, 256, 3),
                                               dtype=np.uint8)


def _pose_dist(got, ref):
    """Per-joint distances between two (N, 16, d) arrays, flat."""
    import numpy as np

    return np.linalg.norm(np.asarray(got, np.float64)
                          - np.asarray(ref, np.float64), axis=-1).ravel()


def _pose_gap(got, ref):
    """(median, max) of the per-joint distance between two (N, 16, d)
    arrays."""
    import numpy as np

    d = _pose_dist(got, ref)
    return float(np.median(d)), float(d.max())


def _tree_frames(data_dir, dev):
    """The H36M tree's images (both splits) cropped to their boxes by the
    port's eval crop, as (N, 256, 256, 3) u8 person frames: what a client
    of /v1/pose sends."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
    from bilinear_tpu_torch.train import hourglass as th

    splits = load_h36m(data_dir)
    out = []
    for task in (Task.Train, Task.Valid):
        pipe = MPIIHostPipeline(H36MImageRecords(splits[task], data_dir),
                                DETECTOR_BATCH, transport="u8")
        for batch in pipe.epoch(1, prefetch=0):
            b = th.batch_tensors(batch, dev)
            crops = th.preprocess_batch(b["images"], b["centers"],
                                        b["scales"], b["keypoints"],
                                        b["valid"], None)[0]
            u8 = (crops * 255.0).round().clamp(0, 255).to(torch.uint8)
            out.append(u8.cpu().numpy()[np.asarray(batch.index) >= 0])
    return np.concatenate(out)


def _swapped_bn_stats(real):
    """K3 eval's wrapper with a planted fault: the second and third BNs'
    running statistics swapped (the same shapes in every ResModule)."""
    def faulty(x4d, p, stats, **kw):
        return real(x4d, p, stats._replace(m2=stats.m3, v2=stats.v3,
                                           m3=stats.m2, v3=stats.v2), **kw)
    return faulty


def drive_e2e_serving(work):
    """A daemon of End2EndServer.from_run_dir(..., model_kw={"fused":
    True}) in bf16 with a LiftingServer beside it (--kind both), serving
    the End2End 1.save. Epoch 2 hot-reloads through /admin/reload (the
    answers change) and /v1/lift still answers through K1. Then /v1/pose
    requests of 1-21 person frames of the H36M tree (its images cropped to
    their boxes) in u8 and f32, two of them (u8 and f32) in one coalesced
    batch, through the trained 2.save. Each answer against (a)
    End2EndServer.predict on the same frames called directly
    (POSE_SELF_GATE), (b) the plain End2End forward (fused=False) in f32 on
    the same weights, no farther than the plain bf16 forward's answers
    (POSE_BF16_RATIO), (c) a u8 request against the f32 request of the
    same frames / 255 (equal bits). Exactly 107 K3-eval launches per
    dispatched chunk. A control: the same frames through K3 eval with a
    planted fault (_swapped_bn_stats) must fail gate (b). Returns
    (launches, K1 launches, record)."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.client import PoseClient
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.ops import resmodule as rk
    from bilinear_tpu_torch.serving import End2EndServer, LiftingServer
    from bilinear_tpu_torch.serving_http import PoseHTTPServer

    save_root = os.path.join(work, "save")
    data_dir = os.path.join(work, "Human3.6M")
    train = load_h36m(data_dir)[Task.Train]
    tree = _tree_frames(data_dir, torch.device("cuda"))

    def frames_of(n, start, dt):
        u8 = np.take(tree, np.arange(start, start + n) % len(tree), axis=0)
        return u8 if dt == "uint8" else u8.astype(np.float32) / \
            np.float32(255.0)

    serve_dir = os.path.join(work, "serve_e2e")
    src = os.path.join(save_root, "End2End", "parameter")
    os.makedirs(os.path.join(serve_dir, "parameter"))
    shutil.copy(os.path.join(src, "1.save"),
                os.path.join(serve_dir, "parameter"))
    e2e = End2EndServer.from_run_dir(serve_dir, train, variant="torch7",
                                     model_kw={"fused": True},
                                     dtype=torch.bfloat16)
    lifting, _ = LiftingServer.from_run_dir(
        os.path.join(save_root, "Bilinear GT"), train, dtype=torch.bfloat16)
    sizes = []
    real_predict = e2e.predict

    def predict(frames, centers=None, scales=None):
        sizes.append(len(frames))
        return real_predict(frames, centers, scales)

    e2e.predict = predict
    http = PoseHTTPServer(lifting=lifting, end2end=e2e, max_delay_ms=300.0,
                          max_rows=64)
    warmed = http.warm(("uint8", "float32"))
    log(f"  warmed {warmed}; {len(tree)} person frames of the H36M tree")
    http.start()
    record = {"requests": [], "self_max": 0.0}
    dist = {k: [] for k in ("served_2d", "plain_2d", "fault_2d",
                            "served_3d", "plain_3d", "fault_3d")}
    try:
        client = PoseClient(f"http://{http.host}:{http.port}")
        probe = frames_of(5, 0, "uint8")
        before = client.pose(probe)
        k1 = _lift_counts()[0]
        kp = 500.0 + 100.0 * np.random.RandomState(SEED + 71).randn(
            4, 16, 2).astype(np.float32)
        lift_before = client.lift(kp)
        shutil.copy(os.path.join(src, "2.save"),
                    os.path.join(serve_dir, "parameter"))
        reloaded = client.reload()
        after = client.pose(probe)
        lift_after = client.lift(kp)
        k1 = _lift_counts()[0] - k1
        health = client.health()
        log(f"  /admin/reload: {reloaded}; health {health}; {k1} K1 "
            f"launches for /v1/lift")
        if not reloaded["reloaded"] or reloaded["epoch"] != 2 or \
                health["pose"]["epoch"] != 2:
            raise AssertionError("epoch 2 was not hot-reloaded")
        if np.array_equal(after[1], before[1]):
            raise AssertionError("the answers did not change with epoch 2")
        if k1 != 2 or not np.array_equal(lift_before, lift_after):
            raise AssertionError("/v1/lift did not answer through K1")
        record["reloaded"] = reloaded

        plain = End2EndServer.from_run_dir(serve_dir, train,
                                           variant="torch7",
                                           dtype=torch.bfloat16)
        plain32 = End2EndServer.from_run_dir(serve_dir, train,
                                             variant="torch7",
                                             dtype=torch.float32)
        if not plain.epoch == plain32.epoch == 2:
            raise AssertionError("the plain servers did not load 2.save")
        sizes.clear()
        _zero_res_counts()
        answers = {}
        for i, (n, dt) in enumerate(POSE_REQUESTS):
            frames = frames_of(n, 3 * i, dt)
            answers[i] = (frames, client.pose(frames))
        mixed = {}

        def ask(j, n, dt):
            frames = frames_of(n, 5 + 7 * j, dt)
            mixed[j] = (frames, client.pose(frames))

        threads = [threading.Thread(target=ask, args=(j, n, dt))
                   for j, (n, dt) in enumerate(POSE_MIXED)]
        batches_before = http.pose_batcher.batches_dispatched
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        coalesced = http.pose_batcher.batches_dispatched - batches_before
        count = _res_counts()
        chunks = sum(len(e2e._chunks(n)) for n in sizes)
        log(f"  {len(POSE_REQUESTS) + len(POSE_MIXED)} /v1/pose requests in "
            f"{len(sizes)} dispatches of {sizes} frames ({chunks} chunks of "
            f"{e2e.batch_sizes}); the mixed u8/f32 pair in {coalesced} "
            f"dispatch; launches {count}")
        if coalesced != 1:
            raise AssertionError("the mixed u8/f32 pair was not coalesced")
        want = {"resmodule_fwd_train": 0, "resmodule_bwd": 0,
                "resmodule_fwd_eval": RES_PER_FORWARD * chunks}
        if count != want:
            raise AssertionError(f"launches {count}, expected {want}")
        launches = count

        failed = []
        real_eval = rk.res_block_eval
        for label, (frames, (p2, p3)) in list(
                (f"request {i} {POSE_REQUESTS[i]}", a)
                for i, a in answers.items()) + list(
                (f"mixed {POSE_MIXED[j]}", a) for j, a in mixed.items()):
            n = len(frames)
            if p2.shape != (n, 16, 2) or p3.shape != (n, 16, 3) or not (
                    np.isfinite(p2).all() and np.isfinite(p3).all()):
                raise AssertionError(f"{label}: {p2.shape} {p3.shape}")
            d2, d3 = real_predict(frames)
            self_gap = max(float(np.abs(p2 - d2).max() /
                                 max(np.abs(d2).max(), 1.0)),
                           float(np.abs(p3 - d3).max() /
                                 max(np.abs(d3).max(), 1.0)))
            b2, b3 = plain.predict(frames)
            r2, r3 = plain32.predict(frames)
            rk.res_block_eval = _swapped_bn_stats(real_eval)
            try:
                f2, f3 = real_predict(frames)
            finally:
                rk.res_block_eval = real_eval
            for key, got, ref in (("served_2d", p2, r2), ("plain_2d", b2, r2),
                                  ("fault_2d", f2, r2),
                                  ("served_3d", p3, r3), ("plain_3d", b3, r3),
                                  ("fault_3d", f3, r3)):
                dist[key].append(_pose_dist(got, ref))
            g2, g3 = _pose_gap(p2, r2), _pose_gap(p3, r3)
            record["requests"].append({"label": label, "self_rel": self_gap,
                                       "pose2d_px_vs_f32": g2,
                                       "pose3d_mm_vs_f32": g3})
            record["self_max"] = max(record["self_max"], self_gap)
            log(f"  {label}: vs predict {self_gap:.1e}; vs the plain f32 "
                f"path pose2d px median {g2[0]:.3f} max {g2[1]:.3f}, pose3d "
                f"mm median {g3[0]:.3f} max {g3[1]:.3f}")
            if self_gap > POSE_SELF_GATE:
                failed.append(f"{label}: {self_gap} from predict")
        for what in ("2d", "3d"):
            q = {k: np.percentile(np.concatenate(dist[f"{k}_{what}"]),
                                  (50, 90)) for k in ("served", "plain",
                                                      "fault")}
            record[f"pose{what}_vs_f32"] = {k: list(map(float, v))
                                            for k, v in q.items()}
            log(f"  pose{what} against the plain f32 path over every frame: "
                f"served (fused bf16) median {q['served'][0]:.3f} p90 "
                f"{q['served'][1]:.3f}; plain bf16 median {q['plain'][0]:.3f}"
                f" p90 {q['plain'][1]:.3f} (gate {POSE_BF16_RATIO}x); "
                f"planted K3 fault median {q['fault'][0]:.3f} p90 "
                f"{q['fault'][1]:.3f}")
            if (q["served"] > POSE_BF16_RATIO * q["plain"]).any():
                failed.append(f"pose{what}: the served answers are farther "
                              f"from the f32 plain path than "
                              f"{POSE_BF16_RATIO}x the plain bf16 ones")
            record[f"fault_caught_{what}"] = bool(
                (q["fault"] > POSE_BF16_RATIO * q["plain"]).any())
        if not (record["fault_caught_2d"] or record["fault_caught_3d"]):
            failed.append("the planted K3 fault passes the served gate")
        u8 = frames_of(5, 11, "uint8")
        a = client.pose(u8)
        b = client.pose(u8.astype(np.float32) / np.float32(255.0))
        same = all(np.array_equal(x, y) for x, y in zip(a, b))
        log(f"  u8 frames vs the same frames as f32 / 255: equal bits "
            f"{same}")
        if not same:
            failed.append("u8 and f32/255 frames answer differently")
        if failed:
            raise AssertionError("; ".join(failed))
    finally:
        http.stop()
    return launches, k1, record


def e2e_parity(work):
    """End2End(fused=True) against End2End(fused=False) at full width in
    f32, train mode, from one state (the End2End 2.save) on one batch with
    the same dropout masks: the loss, per-tensor gradients (median and p99
    of |g_f - g_s| / |g_s|) and the BN buffers after the step, with phase
    7's gates (the median and p90 of PARITY_F32, the p99 reported). Both
    are also held against the standard model in float64 on the same state
    and batch (reported), and so is the standard model with core/norm.py's
    BN formulation (the one the torch7 detector takes on the CPU) in place
    of torch's own (cuDNN) on every detector BN: the measurement that keeps
    torch's BN on the card."""
    import torch
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.io.checkpoint import load_checkpoint
    from bilinear_tpu_torch.models import hourglass_torch7 as ht
    from bilinear_tpu_torch.train import end2end as te
    from bilinear_tpu_torch.train import hourglass as th

    dev = torch.device("cuda")
    data_dir = os.path.join(work, "Human3.6M")
    train = load_h36m(data_dir)[Task.Train]
    payload = load_checkpoint(os.path.join(work, "save", "End2End",
                                           "parameter"), 2)
    b, batch = _e2e_batch(data_dir, dev)
    grads, losses, buffers = {}, {}, {}
    shift_only = set()
    for fused, dtype in ((True, torch.float32), (False, torch.float32),
                         ("core_bn", torch.float32),
                         ("f64", torch.float64)):
        trainer = te.End2EndTrainer(variant="torch7", device=dev,
                                    dtype=dtype,
                                    model_kw={"fused": fused is True})
        state = trainer.init_state(SEED)
        state.model.to(dtype)
        state.restore(payload)
        model = state.model.train()
        shift_only = {f"hourglass.{m}.bias" for m, mod in
                      model.hourglass.named_modules()
                      if isinstance(mod, torch.nn.Conv2d)
                      and not m.startswith("htmapArray.")} | {
            f"bilinear.{m}.0.bias" for m, mod in
            model.bilinear.named_modules()
            if isinstance(mod, torch.nn.Sequential)}
        aug = te.sample_augment(SEED, 1, 1, DETECTOR_BATCH, dev)
        stats = tuple(torch.as_tensor(a, device=dev) for a in
                      (train.mean_part, train.std_part))
        crops, targets, _ = th.preprocess_batch(
            b["images"], b["centers"], b["scales"], b["keypoints"],
            b["valid"], th.Augment(aug.geometry, aug.jitter))
        bn_in = ht.bn_in
        if fused == "core_bn":
            ht.bn_in = lambda bn, x, dt: bn(x.float()).to(dt)
        try:
            heatmaps, _, pose3d = model(
                crops, b["decode_centers"],
                b["decode_scales"] * aug.geometry.scale_factor.to(dev),
                *stats, aug.dropout)
            loss = te.e2e_loss(heatmaps, pose3d, targets[:, trainer.remap],
                               b["s_norm"], 1.0)[0]
            loss.backward()
        finally:
            ht.bn_in = bn_in
        losses[fused] = float(loss.detach())
        grads[fused] = {k: p.grad.detach().clone()
                        for k, p in model.named_parameters()
                        if p.grad is not None}
        buffers[fused] = {k: v.detach().clone()
                          for k, v in model.named_buffers()}
        del trainer, state, model, loss
        torch.cuda.empty_cache()
    worst = {"hourglass": (0.0, ""), "bilinear": (0.0, "")}
    for k, ref in buffers[False].items():
        got = buffers[True][k]
        if k.endswith("num_batches_tracked"):
            if int(got) != int(ref):
                raise AssertionError(f"{k}: {int(got)} fused, {int(ref)} "
                                     f"standard")
        else:
            half = k.split(".")[0]
            worst[half] = max(worst[half], (float(
                ((got - ref).abs() / ref.abs().clamp_min(1e-2)).max()), k))
    gated = [k for k in grads[False] if k not in shift_only]
    rel = _rel_errors(grads[True], grads[False], gated)
    q = _quantiles(rel)
    p99 = rel[int(0.99 * (len(rel) - 1))][0]
    dloss = abs(losses[True] - losses[False]) / abs(losses[False])
    exact = {path: _quantiles(_rel_errors(
        {k: g.double() for k, g in grads[path].items()},
        grads["f64"], gated)) for path in (True, False, "core_bn")}
    log(f"  f32 train step from the End2End 2.save: loss fused "
        f"{losses[True]!r} standard {losses[False]!r} float64 "
        f"{losses['f64']!r} (fused vs standard rel {dloss:.2e}); "
        f"|g_f - g_s|/|g_s| over {len(rel)} tensors: median {q[0.5]:.2e}, "
        f"p90 {q[0.9]:.2e}, p99 {p99:.2e}, max {rel[-1][0]:.2e} "
        f"({rel[-1][1]}); against float64: fused median "
        f"{exact[True][0.5]:.2e} p90 {exact[True][0.9]:.2e}, standard "
        f"median {exact[False][0.5]:.2e} p90 {exact[False][0.9]:.2e}, "
        f"standard with core/norm.py's BN median "
        f"{exact['core_bn'][0.5]:.2e} p90 {exact['core_bn'][0.9]:.2e}; "
        f"{len(shift_only)} biases whose shift a BN removes not gated; BN "
        f"buffers max rel diff: detector {worst['hourglass']}, lifter "
        f"{worst['bilinear']} (gates {E2E_BN_GATES})")
    g_loss, g_med, g_p90 = PARITY_F32
    if not (dloss <= g_loss and q[0.5] <= g_med and q[0.9] <= g_p90):
        raise AssertionError(f"End2End f32 parity out of {PARITY_F32}")
    for half, gate in E2E_BN_GATES.items():
        if worst[half][0] > gate:
            raise AssertionError(f"the fused path's {half} running "
                                 f"statistics disagree: {worst[half]}")
    return {"loss_rel": dloss, "grad_rel_median": q[0.5],
            "grad_rel_p90": q[0.9], "grad_rel_p99": p99,
            "grad_rel_max": rel[-1][0],
            "vs_float64": {"fused": exact[True], "standard": exact[False],
                           "standard_core_bn": exact["core_bn"]},
            "bn_buffers_max_rel": {k: v[0] for k, v in worst.items()}}


def _e2e_batch(data_dir, dev):
    """One H36M batch of 8 with its s_norm rows and original-space boxes,
    as the End2End trainer takes it."""
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.data.h36m_images import H36MImageRecords
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
    from bilinear_tpu_torch.train import end2end as te

    train = load_h36m(data_dir)[Task.Train]
    pipe = MPIIHostPipeline(H36MImageRecords(train, data_dir),
                            DETECTOR_BATCH, shuffle=True, seed=SEED,
                            drop_last=True, transport="u8")
    batch = next(iter(pipe.epoch(1, prefetch=0)))
    return te.End2EndTrainer(device=dev).batch_tensors(
        batch, train.s, train.centers, train.scales), batch


def time_e2e(work):
    """Measurements of phase 12, no gate: the End2End train step (batch 8,
    full width, fused and standard, f32 and bf16: ms/step, img/s,
    device-busy ms and device kernels per step from a trace);
    End2EndServer.predict at 1, 8 and 16 u8 frames (bf16, fused and
    standard: ms and frames/s); and the wall p50 of /v1/pose at 1, 8 and
    16 frames (one request at a time, fused)."""
    import torch
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.serving import End2EndServer
    from bilinear_tpu_torch.serving_http import PoseHTTPServer
    from bilinear_tpu_torch.train import end2end as te

    dev = torch.device("cuda")
    data_dir = os.path.join(work, "Human3.6M")
    train = load_h36m(data_dir)[Task.Train]
    stats = tuple(torch.as_tensor(a, device=dev) for a in
                  (train.mean_part, train.std_part))
    b, _ = _e2e_batch(data_dir, dev)
    out = {"train_step": {}, "predict": {}, "pose_http_p50_ms": {}}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for fused in (True, False):
            trainer = te.End2EndTrainer(variant="torch7", dtype=dtype,
                                        device=dev,
                                        model_kw={"fused": fused})
            state = trainer.init_state(SEED)
            aug = te.sample_augment(SEED, 1, 1, DETECTOR_BATCH, dev)

            def step():
                trainer.train_step(state, b, stats, aug)

            for _ in range(2):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(E2E_TIME_STEPS):
                step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / E2E_TIME_STEPS
            busy, kernels, top = _device_time(step)
            label = f"{'fused' if fused else 'standard'}_{dname}"
            out["train_step"][label] = {
                "ms_per_step": ms, "img_per_s": DETECTOR_BATCH * 1e3 / ms,
                "device_ms_per_step": busy,
                "device_kernels_per_step": kernels,
                "device_idle_share": max(0.0, 1 - busy / ms),
                "device_top": top}
            log(f"  End2End train step {label}: {ms:.2f} ms/step, "
                f"{DETECTOR_BATCH * 1e3 / ms:.1f} img/s (batch "
                f"{DETECTOR_BATCH}, full width); device busy {busy:.2f} "
                f"ms/step in {kernels:.0f} device kernels (idle "
                f"{100 * max(0.0, 1 - busy / ms):.0f}%); top ms/step: "
                + ", ".join(f"{k} {v:.2f}" for k, v in top))
            del trainer, state
            torch.cuda.empty_cache()

    serve_dir = os.path.join(work, "serve_e2e")
    servers = {}
    for fused in (True, False):
        label = "fused" if fused else "standard"
        servers[label] = End2EndServer.from_run_dir(
            serve_dir, train, variant="torch7", model_kw={"fused": fused},
            dtype=torch.bfloat16)
        row = {}
        for n in POSE_TIME_SIZES:
            frames = _pose_frames(n, SEED + 90)
            for _ in range(3):
                servers[label].predict(frames)
            t0 = time.perf_counter()
            for _ in range(POSE_TIME_CALLS):
                servers[label].predict(frames)
            ms = (time.perf_counter() - t0) * 1e3 / POSE_TIME_CALLS
            row[n] = {"ms": ms, "frames_per_s": n * 1e3 / ms}
        out["predict"][label] = row
        log(f"  End2EndServer.predict {label}, bf16, u8 frames: " + ", ".join(
            f"{n} frames {r['ms']:.2f} ms ({r['frames_per_s']:.1f} "
            f"frames/s)" for n, r in row.items()))
    out["pose_http_p50_ms"] = _pose_p50(PoseHTTPServer(
        end2end=servers["fused"], max_delay_ms=0))
    log("  /v1/pose wall p50 (fused, bf16, u8, one request at a time): "
        + ", ".join(f"{n} frames {v:.2f} ms"
                    for n, v in out["pose_http_p50_ms"].items()))
    return out


# ------------------------------------------------------------ phase 13

INT8_BATCHES = (1, 8, 16)
INT8_TIME_BATCH = 8  # a served chunk
# The kernels line's shape: the hourglass 3x3 at 64 x 64 (B, H, W, Ci, Co,
# k), the most frequent large conv of a forward.
INT8_MAIN_SHAPE = (8, 64, 64, 128, 128, 3)
# The distinct (H, W, Ci, Co, k) of the int8 convs of a full-width torch7
# and preact forward (int8_conv_shapes checks that the models still give
# these), the largest first.
INT8_SHAPES = (
    (128, 128, 64, 64, 1), (128, 128, 64, 64, 3), (128, 128, 64, 128, 1),
    (64, 64, 64, 64, 3), (64, 64, 64, 128, 1), (64, 64, 128, 64, 1),
    (64, 64, 128, 128, 1), (64, 64, 128, 128, 3), (64, 64, 128, 256, 1),
    (64, 64, 256, 128, 1), (32, 32, 128, 128, 3), (32, 32, 128, 256, 1),
    (32, 32, 256, 128, 1), (16, 16, 128, 128, 3), (16, 16, 128, 256, 1),
    (16, 16, 256, 128, 1), (8, 8, 128, 128, 3), (8, 8, 128, 256, 1),
    (8, 8, 256, 128, 1), (4, 4, 128, 128, 3), (4, 4, 128, 256, 1),
    (4, 4, 256, 128, 1))
# Shapes K7 takes beside the forward's, each at one batch: the preact
# heatmap head's width (Co = 16, which the JAX package keeps float), an M
# (3 x 7 x 9 = 189) that is no multiple of the 128-row tile with a Co (48)
# that is no tile width, and Ci = 192 (a 128-byte slab of K across two
# taps at every other slab) with Co = 320 (two column tiles); samples that
# end in a partial tile of K6 (8,192 values) in its cluster route (13 x 11 x
# 128: 2.2 tiles) and its cooperative route (45 x 41 x 64: 14.4 tiles).
INT8_EXTRA_SHAPES = ((8, (64, 64, 256, 16, 1)), (3, (7, 9, 64, 48, 3)),
                     (2, (5, 3, 192, 320, 3)), (2, (13, 11, 128, 32, 1)),
                     (2, (45, 41, 64, 16, 1)))
# The shape of the planted dropped split: a split-K shape of a served chunk.
INT8_SPLIT_SHAPE = (8, 16, 16, 128, 128, 3)
# K7 launches per forward: three body convs per ResModule (torch7, 107) or
# ResUnit (preact, 3 + 8 * 14 = 115); one K6 launch before each.
INT8_PER_FORWARD = {"torch7": 3 * RES_PER_FORWARD, "preact": 3 * (3 + 8 * 14)}
# JAX's int8-versus-float gates (tests/test_hourglass_int8.py:82-102 and
# :155-160): last-stack heatmaps mean / max |d| against their range,
# soft-argmax decode shift mean / max in heatmap pixels, pose2d mean pixels,
# pose3d mean |d| against mean |mm|. JAX set them on a briefly trained tiny
# detector; the served checkpoint here is a barely trained full-width one
# whose last-stack heatmaps are nearly flat, so the x10 soft-argmax turns
# any rounding into pixels (bf16 against f32 moves pose2d by pixels too,
# phase 12): the heatmap gates are held; the decode measures are held
# relative, the int8 model no farther from the plain f32 model than
# POSE_BF16_RATIO times the bf16 model is, and JAX's absolute numbers are
# reported.
INT8_HEATMAP_GATES = (0.01, 0.05)
INT8_DECODE_GATES = (0.5, 2.0)
INT8_POSE2D_GATE = 2.0
INT8_MM_GATE = 0.1
INT8_POSE_SIZES = (1, 8, 16)
INT8_TIME_CALLS = 50
# Device kernel names of K6 and K7 in a trace (K6: its cooperative kernel
# or its cluster-per-sample kernel).
INT8_KERNEL_NAMES = {"int8_quantize": ("quantize_kernel",
                                       "quantize_sample_kernel"),
                     "int8_conv": ("int8_conv_kernel",)}
# K6's route, by the device kernel a trace shows it ran.
K6_ROUTES = {"quantize_kernel": "cooperative_grid",
             "quantize_sample_kernel": "cluster_per_sample"}


def _int8_counts():
    from bilinear_tpu_torch.ops import int8

    return {"int8_quantize": int8.LAUNCHES_QUANTIZE,
            "int8_conv": int8.LAUNCHES_CONV}


def _zero_int8_counts():
    from bilinear_tpu_torch.ops import int8

    int8.LAUNCHES_QUANTIZE = int8.LAUNCHES_CONV = 0


def int8_conv_shapes():
    """The distinct (H, W, Ci, Co, k) of the int8 convs of one full-width
    torch7 and one full-width preact forward (bf16, quantize="int8", batch
    1), recorded at the one-call wrapper; each forward must launch K6 and
    K7 INT8_PER_FORWARD times and K3 never (the fused torch7 model bypasses
    its blocks in int8 eval), and the shapes must be INT8_SHAPES."""
    import torch
    from bilinear_tpu_torch.models.hourglass import StackedHourglass
    from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
    from bilinear_tpu_torch.ops import int8

    shapes, per_forward = set(), {}
    real = int8.int8_conv_fused_cuda

    def record(x, prepared, out_dtype):
        shapes.add(tuple(x.shape[1:]) + (prepared.kq.shape[0],
                                         prepared.kq.shape[1]))
        return real(x, prepared, out_dtype)

    int8.int8_conv_fused_cuda = record
    try:
        for name, model in (
                ("torch7", MainModel(quantize="int8", fused=True,
                                     dtype=torch.bfloat16)),
                ("preact", StackedHourglass(quantize="int8",
                                            dtype=torch.bfloat16))):
            model = model.cuda().eval()
            _zero_int8_counts()
            _zero_res_counts()
            with torch.no_grad():
                model(torch.rand(1, 256, 256, 3, device="cuda"))
            torch.cuda.synchronize()
            per_forward[name] = dict(_int8_counts(), **_res_counts())
            want = INT8_PER_FORWARD[name]
            got = per_forward[name]
            if got["int8_conv"] != want or got["int8_quantize"] != want or \
                    any(got[k] for k in _res_counts()):
                raise AssertionError(f"{name} int8 forward launches {got}, "
                                     f"expected {want} of K6 and K7, no K3")
            del model
    finally:
        int8.int8_conv_fused_cuda = real
    out = sorted(shapes, key=lambda s: (-s[0], s[2], s[3], s[4]))
    log(f"  {len(out)} distinct int8 conv shapes (H, W, Ci, Co, k) over a "
        f"full torch7 and a full preact forward: {out}; launches per "
        f"forward {per_forward}")
    if tuple(out) != INT8_SHAPES:
        raise AssertionError(f"the int8 conv shapes are not INT8_SHAPES: "
                             f"{out}")
    return out, per_forward


def _int8_operands(shape, b, dtype, gen, bias=True):
    """Seeded NHWC activations whose samples differ in range, an HWIO
    kernel with per-channel ranges and a bias, on the card."""
    import torch

    h, w, ci, co, k = shape
    x = (torch.randn(b, h, w, ci, generator=gen)
         * (torch.rand(b, 1, 1, 1, generator=gen) * 3 + 0.1))
    kern = torch.randn(k, k, ci, co, generator=gen) * (
        torch.rand(1, 1, 1, co, generator=gen) * 0.1 + 0.01)
    bias_t = torch.randn(co, generator=gen) if bias else None
    return (x.to(dtype).cuda(), kern.cuda(),
            None if bias_t is None else bias_t.cuda())


def _int8_plans(b, shape):
    """Every K7 plan of a shape: each instantiated tile through each route
    K admits (split-K needs two slabs)."""
    from bilinear_tpu_torch.ops import int8

    h, w, ci, co, k = shape
    return [int8.plan_conv(b, h, w, ci, co, k, route, bn, depth)
            for bn, depth in int8.TILES for route in int8.ROUTES
            if route == "wgmma" or k * k * ci > int8.SLAB]


def check_int8_kernels(shapes):
    """K6 and K7 against their plain versions on the card, bit for bit, at
    every shape of ``shapes`` at batch 1, 8 and 16, bf16 and f32, and the
    INT8_EXTRA_SHAPES (bf16, and without a bias): K6's int8 values and
    scales; K7's int32 accumulator and outputs through its own plan; the
    one-call entry's outputs; and at batch 8 in bf16, every other plan
    (each route and tile forced through plan_conv where it is not chosen:
    its accumulator and outputs). Two planted faults must change the
    result: K7 given the scales of the wrong sample, and a split-K plan
    with its last split dropped. Returns ({kernel: max |diff|}, {route:
    cases})."""
    import torch
    from bilinear_tpu_torch.ops import int8

    gen = torch.Generator().manual_seed(SEED + 130)
    errs = {"int8_quantize": 0.0, "int8_conv": 0.0}
    routes = {}
    cases = [(s, b, dt, True) for s in shapes for b in INT8_BATCHES
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(s, b, torch.bfloat16, bias) for b, s in INT8_EXTRA_SHAPES
              for bias in (True, False)]
    t0 = time.perf_counter()
    planted = set()
    for shape, b, dt, with_bias in cases:
        x, kern, bias = _int8_operands(shape, b, dt, gen, with_bias)
        prepared = int8.prepare_kernel(kern, bias)
        xq, sx = int8.quantize_activations(x)
        xr, sr = int8.quantize_activations_ref(x)
        accr = int8.int8_conv_acc_ref(xr, prepared.kq)
        yr = int8.dequantize_ref(accr, sr, prepared, dt)
        own = int8.plan_conv(b, *shape)
        plans = [own]
        if b == INT8_TIME_BATCH and dt == torch.bfloat16:
            plans += [p for p in _int8_plans(b, shape) if p != own]
        eq = [torch.equal(xq, xr) and torch.equal(sx, sr)]
        for plan in plans:
            acc = int8.int8_conv_cuda(xq, None, prepared, torch.int32, plan)
            y = int8.int8_conv_cuda(xq, sx, prepared, dt, plan)
            eq += [torch.equal(acc, accr), torch.equal(y, yr)]
            errs["int8_conv"] = max(errs["int8_conv"], float(
                (y.float() - yr.float()).abs().max()))
            key = f"{plan.route}/{plan.bn}x{plan.depth}"
            routes[key] = routes.get(key, 0) + 1
        fused = int8.int8_conv(x, prepared=prepared, out_dtype=dt)
        eq.append(torch.equal(fused, yr))
        errs["int8_quantize"] = max(errs["int8_quantize"], float(
            (xq.int() - xr.int()).abs().max()))
        if not all(eq):
            raise AssertionError(
                f"int8 kernels at (B={b}, H, W, Ci, Co, k)={shape} {dt} "
                f"bias={with_bias}: quantize, then accumulator/output per "
                f"plan {plans}, then the one-call entry: equal {eq}")
        if (b,) + tuple(shape) == INT8_MAIN_SHAPE and with_bias \
                and dt == torch.bfloat16:
            wrong = int8.int8_conv_cuda(xq, torch.roll(sx, 1, 0), prepared,
                                        dt)
            if torch.equal(wrong, yr):
                raise AssertionError("K7 with the scales of the wrong "
                                     "sample matched the plain version")
            planted.add("scales")
            log("  planted fault (K7 given the scales of the wrong sample): "
                f"max |d| {float((wrong.float() - yr.float()).abs().max()):.3e}"
                " from the plain version: caught")
        if (b,) + tuple(shape) == INT8_SPLIT_SHAPE and with_bias \
                and dt == torch.bfloat16:
            if own.splits < 2:
                raise AssertionError(f"{INT8_SPLIT_SHAPE} is planned "
                                     f"without split-K: {own}")
            dropped = own._replace(splits=own.splits - 1)
            wrong = int8.int8_conv_cuda(xq, None, prepared, torch.int32,
                                        dropped)
            if torch.equal(wrong, accr):
                raise AssertionError("K7 with a dropped split matched the "
                                     "plain accumulator")
            planted.add("split")
            log(f"  planted fault (the last of {own.splits} splits of K "
                f"dropped at {INT8_SPLIT_SHAPE}): max |d| "
                f"{int((wrong.long() - accr.long()).abs().max())} in the "
                "int32 accumulator: caught")
    if planted != {"scales", "split"}:
        raise AssertionError(f"planted faults run: {planted}")
    log(f"  K6/K7 vs the plain versions: {len(cases)} cases (every shape at "
        f"batch {INT8_BATCHES}, bf16 and f32, and the extra shapes), K7 "
        f"plans run {routes}: int8 values, scales, int32 accumulators and "
        f"outputs bit-equal; {time.perf_counter() - t0:.1f} s")
    return errs, routes


def _im2col_int8(xq, k):
    """(B*H*W, k*k*Ci) int8 im2col of NHWC int8 ``xq`` (channel-major taps,
    as F.unfold gives them): the int8 GEMM yardstick's operand."""
    import torch.nn.functional as F

    b, h, w, ci = xq.shape
    cols = F.unfold(xq.permute(0, 3, 1, 2).float(), k, padding=(k - 1) // 2)
    return cols.transpose(1, 2).reshape(b * h * w, ci * k * k).to(
        xq.dtype).contiguous()


def int8_bound(kind, b, shape, out_itemsize=2):
    """Least time (ms): K7's int8 operations 2 M Co K at 1,979 TOP/s
    against its bytes (int8 activations and weights read once, the output
    written once) at 3.35 TB/s; K6's bytes (x read once, int8 written
    once)."""
    h, w, ci, co, k = shape
    m = b * h * w
    if kind == "int8_quantize":
        nbytes = m * ci * (out_itemsize + 1) + 4 * b
        return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
    ops = 2 * m * co * k * k * ci
    nbytes = m * ci + co * k * k * ci + m * co * out_itemsize + 4 * (b + 2 * co)
    ops_s, bytes_s = ops / PEAK_INT8, nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _int8_kernel_split(per):
    """{"int8_quantize" / "int8_conv" / "other": (ms, kernels)} per call of
    a trace's {kernel: (ms, launches)}."""
    out = {"int8_quantize": [0.0, 0.0], "int8_conv": [0.0, 0.0],
           "other": [0.0, 0.0]}
    for key, (ms, cnt) in per.items():
        kind = next((k for k, names in INT8_KERNEL_NAMES.items()
                     if any(n in key for n in names)), "other")
        out[kind][0] += ms
        out[kind][1] += cnt
    return {k: tuple(v) for k, v in out.items()}


def _k6_route(per):
    """K6's route in a trace of K6 + K7 calls: the K6_ROUTES name of each
    device kernel that is not K7's (of any other kernel, its name), joined
    by '+'."""
    routes = set()
    for key in per:
        if any(n in key for n in INT8_KERNEL_NAMES["int8_conv"]):
            continue
        routes.add(next((r for n, r in K6_ROUTES.items()
                         if re.search(rf"\b{n}\b", key)), key[:80]))
    return "+".join(sorted(routes))


def time_int8(shapes, q=None):
    """K7 and K6 at every int8 conv shape at batch 8 (and the main shape
    at 1 and 16), bf16: by CUDA events (K7 alone, K6 alone and the one-call
    entry) and by a profiler trace of one K6 + K7 pair (each one's device
    ms and device kernels per call), beside each bound, cuDNN's bf16 conv
    of the same shape (by events and by trace) and torch._int_mm over an
    int8 im2col (the GEMM alone: yardsticks, not what the port calls);
    K7's route; the plain versions at the main shape. ``q`` is the ops.int8 module to time (by
    default this checkout's): any checkout's, for a before run. Returns
    {"per_shape": [...], "main": {...}}."""
    import torch
    import torch.nn.functional as F

    if q is None:
        from bilinear_tpu_torch.ops import int8 as q
    gen = torch.Generator().manual_seed(SEED + 131)
    rows = []
    main_shape = tuple(INT8_MAIN_SHAPE[1:])
    todo = [(INT8_TIME_BATCH, s) for s in shapes]
    todo += [(b, main_shape) for b in INT8_BATCHES if b != INT8_TIME_BATCH]
    for b, shape in todo:
        h, w, ci, co, k = shape
        x, kern, bias = _int8_operands(shape, b, torch.bfloat16, gen)
        prepared = q.prepare_kernel(kern, bias)
        xq, sx = q.quantize_activations(x)
        iters = INT8_TIME_CALLS
        row = {"shape_bhwcok": [b, h, w, ci, co, k]}
        if hasattr(q, "plan_conv"):
            row["k7_route"] = q.plan_conv(b, h, w, ci, co, k)._asdict()

        def k7():
            return q.int8_conv_cuda(xq, sx, prepared, torch.bfloat16)

        def k6():
            return q.quantize_activations(x)

        row["k7_ms"] = cuda_ms(k7, iters)
        row["k6_ms"] = cuda_ms(k6, iters)
        row["one_call_ms"] = cuda_ms(lambda: q.int8_conv(
            x, prepared=prepared), iters)
        # One K6 + K7 pair: every kernel but K7's is K6's (another
        # checkout's K6 may be several device operations).
        per = _trace_whole(lambda: (k6(), k7()), 10)
        split = _int8_kernel_split(per)
        row["k6_route"] = _k6_route(per)
        row["k7_trace_ms"], row["k7_device_kernels_per_call"] = \
            split["int8_conv"]
        row["k6_trace_ms"] = split["int8_quantize"][0] + split["other"][0]
        row["k6_device_kernels_per_call"] = (split["int8_quantize"][1]
                                             + split["other"][1])
        row["k7_bound_ms"], row["k7_bound_by"] = int8_bound(
            "int8_conv", b, shape)
        row["k6_bound_ms"], _ = int8_bound("int8_quantize", b, shape)
        xn = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        wn = kern.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        row["cudnn_bf16_conv_ms"] = cuda_ms(
            lambda: F.conv2d(xn, wn, padding=(k - 1) // 2), iters)
        row["cudnn_bf16_conv_trace_ms"] = sum(ms for ms, _ in _trace_whole(
            lambda: F.conv2d(xn, wn, padding=(k - 1) // 2), 10).values())
        a = _im2col_int8(xq, k)
        bm = prepared.kq.permute(0, 3, 1, 2).reshape(co, -1).t()
        row["int_mm_im2col_ms"] = cuda_ms(
            lambda: torch._int_mm(a, bm), iters) if a.shape[0] > 16 else None
        if b == INT8_TIME_BATCH and shape == main_shape:
            row["k7_plain_ms"] = cuda_ms(lambda: q.dequantize_ref(
                q.int8_conv_acc_ref(xq, prepared.kq), sx, prepared,
                torch.bfloat16), 5)
            row["k6_plain_ms"] = cuda_ms(
                lambda: q.quantize_activations_ref(x), 5)
        rows.append(row)
        route = row.get("k7_route", {})
        log(f"  int8 conv (B, H, W, Ci, Co, k)=({b}, {h}, {w}, {ci}, {co}, "
            f"{k}) [{route.get('route', 'mma.sync')} bn {route.get('bn')} "
            f"splits {route.get('splits')}]: K7 by trace "
            f"{row['k7_trace_ms']:.4f} ms in "
            f"{row['k7_device_kernels_per_call']:.0f} kernel(s) (events "
            f"{row['k7_ms']:.4f}; bound {row['k7_bound_ms']:.4f}, "
            f"{row['k7_bound_by']}; {row['k7_trace_ms'] / row['k7_bound_ms']:.1f}"
            f"x), K6 by trace {row['k6_trace_ms']:.4f} in "
            f"{row['k6_device_kernels_per_call']:.0f} [{row['k6_route']}] "
            f"(events "
            f"{row['k6_ms']:.4f}; bound {row['k6_bound_ms']:.4f}), one call "
            f"K6+K7 {row['one_call_ms']:.4f}; cuDNN bf16 conv by trace "
            f"{row['cudnn_bf16_conv_trace_ms']:.4f} (events "
            f"{row['cudnn_bf16_conv_ms']:.4f}), _int_mm im2col "
            f"{row['int_mm_im2col_ms']}"
            + (f"; plain K7 {row['k7_plain_ms']:.4f}, plain K6 "
               f"{row['k6_plain_ms']:.4f}" if "k7_plain_ms" in row else ""))
        del x, xq, a
    main = next(r for r in rows if r["shape_bhwcok"] == list(INT8_MAIN_SHAPE))
    at8 = [r for r in rows if r["shape_bhwcok"][0] == INT8_TIME_BATCH]
    log(f"  summed over the {len(shapes)} distinct shapes at batch "
        f"{INT8_TIME_BATCH}: K7 {sum(r['k7_trace_ms'] for r in at8):.4f} ms "
        f"by trace ({sum(r['k7_ms'] for r in at8):.4f} by events), K6 "
        f"{sum(r['k6_trace_ms'] for r in at8):.4f} by trace")
    return {"per_shape": rows, "main": main}


def int8_forward_totals(model_cls, batches=INT8_POSE_SIZES):
    """The launch-weighted cost of the int8 convs: one bf16 int8 eval
    forward of a full-width, randomly initialised ``model_cls`` (a torch7
    MainModel, fused, of any checkout) at each batch, traced: device ms
    and kernels of the forward, K6's and K7's among them (by the names of
    INT8_KERNEL_NAMES: another checkout's K6 kernels of other names count
    with "other")."""
    import torch

    model = model_cls(quantize="int8", fused=True, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(SEED))
    model = model.cuda().eval()
    out = {}
    for n in batches:
        x = torch.rand(n, 256, 256, 3, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(n))

        def forward():
            with torch.no_grad():
                return model(x)

        split = _int8_kernel_split(_trace_whole(forward, 1))
        rec = {"device_ms": sum(ms for ms, _ in split.values()),
               "device_kernels": sum(c for _, c in split.values())}
        for key in INT8_KERNEL_NAMES:
            rec[f"{key}_ms"], rec[f"{key}_kernels"] = split[key]
        out[n] = rec
        log(f"  one int8 forward of {n} frames by trace: "
            f"{rec['device_ms']:.3f} ms of device time in "
            f"{rec['device_kernels']:.0f} kernels; K6's named kernels "
            f"{rec['int8_quantize_ms']:.3f} ms in "
            f"{rec['int8_quantize_kernels']:.0f}, K7 "
            f"{rec['int8_conv_ms']:.3f} ms in {rec['int8_conv_kernels']:.0f}")
    return out


def _last_heatmaps(server, frames):
    """(last-stack heatmaps (N, 64, 64, 16), pose2d, pose3d mm) of a
    server's model on u8 ``frames`` in chunks of 16, full-frame boxes, with
    every chunk's answers as predict returns them."""
    import numpy as np
    import torch

    model, dev = server._model, server.device
    hms, p2s, p3s = [], [], []
    with torch.no_grad():
        for i in range(0, len(frames), 16):
            f = torch.from_numpy(frames[i:i + 16]).to(dev).float() / 255.0
            n = f.shape[0]
            hm, p2, p3 = model(f, torch.full((n, 2), 128.0, device=dev),
                               torch.full((n,), 256.0 / 200.0, device=dev),
                               server._mean_part, server._std_part)
            hms.append(hm[-1].float().cpu().numpy())
            p2s.append(p2.float().cpu().numpy())
            p3s.append((p3.float().cpu().numpy() * server._std_s
                         + server._mean_s).reshape(n, 16, 3))
    return (np.concatenate(hms), np.concatenate(p2s), np.concatenate(p3s))


def _int8_gates(q, f):
    """JAX's int8-versus-float measures of (heatmaps, pose2d, mm) ``q``
    against ``f``: returns (record, the names of the gates missed)."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.ops.decode import softargmax

    hq, pq, mq = q
    hf, pf, mf = f
    rng = float(hf.max() - hf.min())
    d = np.abs(hq - hf)

    def dec(h):
        return softargmax(torch.from_numpy(h).permute(0, 3, 1, 2)).numpy()

    shift = np.linalg.norm(dec(hq) - dec(hf), axis=-1)
    p2 = float(np.linalg.norm(pq - pf, axis=-1).mean())
    mm = float(np.abs(mq - mf).mean() / (np.abs(mf).mean() + 1e-9))
    rec = {"heatmap_mean_of_range": float(d.mean() / rng),
           "heatmap_max_of_range": float(d.max() / rng),
           "decode_shift_mean_px": float(shift.mean()),
           "decode_shift_max_px": float(shift.max()),
           "pose2d_mean_px": p2, "mm_mean_rel": mm}
    fails = []
    if rec["heatmap_mean_of_range"] >= INT8_HEATMAP_GATES[0] or \
            rec["heatmap_max_of_range"] >= INT8_HEATMAP_GATES[1]:
        fails.append("heatmaps")
    if rec["decode_shift_mean_px"] >= INT8_DECODE_GATES[0] or \
            rec["decode_shift_max_px"] >= INT8_DECODE_GATES[1]:
        fails.append("decode shift")
    if p2 >= INT8_POSE2D_GATE:
        fails.append("pose2d")
    if mm >= INT8_MM_GATE:
        fails.append("mm")
    return rec, fails


def _plain_int8():
    """Context: the int8 convs through their plain versions on the card
    (the one-call K6 + K7 wrapper replaced by the plain function)."""
    import contextlib

    from bilinear_tpu_torch.ops import int8

    @contextlib.contextmanager
    def ctx():
        saved = int8.int8_conv_fused_cuda
        int8.int8_conv_fused_cuda = lambda x, p, dt: int8.int8_conv_ref(
            x, prepared=p, out_dtype=dt)
        try:
            yield
        finally:
            int8.int8_conv_fused_cuda = saved
    return ctx()


def _rel_gap(a, b):
    """max |a - b| over max |b|, over (heatmaps, pose2d, mm) triples."""
    import numpy as np

    return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-9))
               for x, y in zip(a, b))


def drive_int8_serving(work):
    """The int8 slice through the serve CLI on the card: ``--kind both
    --quantize int8`` on phase 12's End2End 2.save and phase 9's lifting
    checkpoint (a torch7 detector, fused, whose int8 ResModules bypass K3;
    lifting through K2). /v1/pose at 1, 8 and 16 person frames of the H36M
    tree: each answer equals End2EndServer.predict on the same frames
    (POSE_SELF_GATE), exactly INT8_PER_FORWARD K6 and K7 launches per
    served chunk and no K3. Every tree frame through the int8 model: equal
    (POSE_SELF_GATE) to the same model with the int8 convs' plain versions,
    within JAX's heatmap gates of the bf16 fused model (phase 12's served
    path), JAX's decode measures reported beside the bf16 model's distance
    from the plain f32 one; a planted fault (K7 given the scales of the
    wrong sample) must fail the plain-version gate. Returns (launches,
    record)."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.cli import serve
    from bilinear_tpu_torch.client import PoseClient
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.ops import int8
    from bilinear_tpu_torch.serving import End2EndServer

    save_root = os.path.join(work, "save")
    data_dir = os.path.join(work, "Human3.6M")
    serve_dir = os.path.join(work, "serve_e2e")
    train = load_h36m(data_dir)[Task.Train]
    tree = _tree_frames(data_dir, torch.device("cuda"))
    args = serve.build_parser().parse_args(
        ["--kind", "both", "--run-dir", serve_dir, "--lifting-run-dir",
         os.path.join(save_root, "Bilinear GT"), "--data-dir", data_dir,
         "--quantize", "int8", "--port", "0", "--max-delay-ms", "0"])
    http = serve.build_server(args)
    e2e = http.end2end
    if e2e.quantize != "int8" or e2e.epoch != 2 or \
            not e2e._model.hourglass.hgArray[0].res1[0].fused:
        raise AssertionError("serve --quantize int8 did not build a fused "
                             "int8 End2EndServer on 2.save")
    warmed = http.warm(("uint8",))
    http.start()
    record = {"requests": []}
    launches = {k: 0 for k in list(_int8_counts()) + list(_res_counts())}
    try:
        client = PoseClient(f"http://{http.host}:{http.port}")
        for i, n in enumerate(INT8_POSE_SIZES):
            frames = np.take(tree, np.arange(3 * i, 3 * i + n) % len(tree),
                             axis=0)
            _zero_int8_counts()
            _zero_res_counts()
            p2, p3 = client.pose(frames)
            count = dict(_int8_counts(), **_res_counts())
            chunks = len(e2e._chunks(n))
            want = INT8_PER_FORWARD["torch7"] * chunks
            if count["int8_conv"] != want or count["int8_quantize"] != want \
                    or any(count[k] for k in _res_counts()):
                raise AssertionError(f"/v1/pose of {n} frames: launches "
                                     f"{count}, expected {want} of K6 and K7"
                                     ", no K3")
            for k, v in count.items():
                launches[k] += v
            d2, d3 = e2e.predict(frames)
            self_gap = max(float(np.abs(p2 - d2).max() /
                                 max(np.abs(d2).max(), 1.0)),
                           float(np.abs(p3 - d3).max() /
                                 max(np.abs(d3).max(), 1.0)))
            record["requests"].append({"frames": n, "chunks": chunks,
                                       "launches": count,
                                       "self_rel": self_gap})
            log(f"  /v1/pose int8, {n} frames ({chunks} chunk): launches "
                f"{count}; vs predict {self_gap:.1e}")
            if self_gap > POSE_SELF_GATE or not np.isfinite(p3).all():
                raise AssertionError(f"int8 /v1/pose of {n} frames: "
                                     f"{self_gap} from predict")
        kp = 500.0 + 100.0 * np.random.RandomState(SEED + 72).randn(
            4, 16, 2).astype(np.float32)
        k2 = _lift_counts()[1]
        mm = client.lift(kp)
        if _lift_counts()[1] - k2 != 1 or not np.isfinite(mm).all():
            raise AssertionError("/v1/lift int8 did not answer through K2")
    finally:
        http.stop()
    log(f"  serve --kind both --quantize int8: warmed {warmed}; /v1/lift "
        "through K2")

    def server(dtype, fused):
        return End2EndServer.from_run_dir(
            serve_dir, train, variant="torch7", model_kw={"fused": fused},
            dtype=dtype)

    q = _last_heatmaps(e2e, tree)
    with _plain_int8():
        plain = _last_heatmaps(e2e, tree)
    bf16 = _last_heatmaps(server(torch.bfloat16, True), tree)
    f32 = _last_heatmaps(server(torch.float32, False), tree)
    record["served_vs_plain_int8"] = _rel_gap(q, plain)
    rec, missed = _int8_gates(q, bf16)
    record["int8_vs_bf16"] = dict(rec, missed=missed)
    record["bf16_vs_f32"], _ = _int8_gates(bf16, f32)
    record["int8_vs_f32"], _ = _int8_gates(q, f32)
    real = int8.int8_conv_fused_cuda

    def wrong_scales(x, p, dt):  # K6, then K7 on rolled scales
        xq, sx = int8.quantize_activations(x)
        return int8.int8_conv_cuda(xq, torch.roll(sx, 1, 0), p, dt)

    int8.int8_conv_fused_cuda = wrong_scales
    try:
        fault = _last_heatmaps(e2e, tree)
    finally:
        int8.int8_conv_fused_cuda = real
    record["fault_vs_plain_int8"] = _rel_gap(fault, plain)
    log(f"  int8 model on {len(tree)} tree frames: K6/K7 against the plain "
        f"int8 convs {record['served_vs_plain_int8']:.2e} (gate "
        f"{POSE_SELF_GATE}); planted fault (K7 given the scales of the "
        f"wrong sample) {record['fault_vs_plain_int8']:.2e}")
    for label in ("int8_vs_bf16", "bf16_vs_f32", "int8_vs_f32"):
        log(f"  {label}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in record[label].items()))
    log(f"  JAX's gates: heatmaps {INT8_HEATMAP_GATES} of the range (held), "
        f"decode shift {INT8_DECODE_GATES} px, pose2d {INT8_POSE2D_GATE} "
        f"px, mm {INT8_MM_GATE} (reported; int8 held to {POSE_BF16_RATIO}x "
        "bf16's distance from f32)")
    relative = ("decode_shift_mean_px", "pose2d_mean_px", "mm_mean_rel")
    far = [k for k in relative if record["int8_vs_f32"][k]
           > POSE_BF16_RATIO * record["bf16_vs_f32"][k]]
    if record["served_vs_plain_int8"] > POSE_SELF_GATE:
        raise AssertionError("the int8 model through K6/K7 is off its plain "
                             "version")
    if record["fault_vs_plain_int8"] <= POSE_SELF_GATE:
        raise AssertionError("the planted int8 fault passes the gate")
    if "heatmaps" in missed:
        raise AssertionError("int8 heatmaps outside JAX's gates of bf16")
    if far:
        raise AssertionError(f"int8 farther from f32 than {POSE_BF16_RATIO}x"
                             f" bf16 in {far}")
    return launches, record


def time_int8_serving(work):
    """End2EndServer.predict, int8 (fused torch7, K6/K7) against bf16
    fused (K3), at 1, 8 and 16 u8 frames: ms and frames/s, and from a trace
    of one call the chunk's device ms and kernels, K6's and K7's among them
    (the launch-weighted cost of the int8 convs per chunk); /v1/pose wall
    p50 of both servers (one request at a time)."""
    import torch
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.serving import End2EndServer
    from bilinear_tpu_torch.serving_http import PoseHTTPServer

    data_dir = os.path.join(work, "Human3.6M")
    serve_dir = os.path.join(work, "serve_e2e")
    train = load_h36m(data_dir)[Task.Train]
    out = {"predict": {}, "pose_http_p50_ms": {}}
    servers = {q or "bf16": End2EndServer.from_run_dir(
        serve_dir, train, variant="torch7", model_kw={"fused": True},
        dtype=torch.bfloat16, quantize=q) for q in ("int8", None)}
    for turn in ("int8", "bf16", "bf16", "int8"):
        row = out["predict"].setdefault(turn, {})
        for n in POSE_TIME_SIZES:
            frames = _pose_frames(n, SEED + 92)
            for _ in range(3):
                servers[turn].predict(frames)
            t0 = time.perf_counter()
            for _ in range(POSE_TIME_CALLS):
                servers[turn].predict(frames)
            ms = (time.perf_counter() - t0) * 1e3 / POSE_TIME_CALLS
            row.setdefault(n, []).append(ms)
    for label, row in out["predict"].items():
        for n, v in row.items():
            row[n] = {"ms": min(v), "ms_turns": v,
                      "frames_per_s": n * 1e3 / min(v)}
        log(f"  End2EndServer.predict {label} (fused torch7, u8; best of two "
            "turns): " + ", ".join(f"{n} frames {r['ms']:.2f} ms "
                                   f"({r['frames_per_s']:.1f} frames/s)"
                                   for n, r in row.items()))
    out["chunk_trace"] = {}
    for label, server in servers.items():
        for n in POSE_TIME_SIZES:
            frames = _pose_frames(n, SEED + 92)
            split = _int8_kernel_split(_trace_whole(
                lambda: server.predict(frames), 1))
            rec = {"device_ms": sum(ms for ms, _ in split.values()),
                   "device_kernels": sum(c for _, c in split.values())}
            for key in INT8_KERNEL_NAMES:
                rec[f"{key}_ms"], rec[f"{key}_kernels"] = split[key]
            out["chunk_trace"].setdefault(label, {})[n] = rec
            log(f"  one {label} chunk of {n} frames by trace: "
                f"{rec['device_ms']:.3f} ms of device time in "
                f"{rec['device_kernels']:.0f} kernels; K6 "
                f"{rec['int8_quantize_ms']:.3f} ms in "
                f"{rec['int8_quantize_kernels']:.0f}, K7 "
                f"{rec['int8_conv_ms']:.3f} ms in "
                f"{rec['int8_conv_kernels']:.0f}")
    for label in ("int8", "bf16"):
        out["pose_http_p50_ms"][label] = _pose_p50(PoseHTTPServer(
            end2end=servers[label], max_delay_ms=0))
        log(f"  /v1/pose wall p50 ({label}, u8, one request at a time): "
            + ", ".join(f"{n} frames {v:.2f} ms" for n, v in
                        out["pose_http_p50_ms"][label].items()))
    return out


def _pose_p50(http, calls=POSE_TIME_CALLS):
    """Wall p50 of /v1/pose at POSE_TIME_SIZES u8 frames over ``calls``
    requests, one at a time, through ``http`` (started and stopped
    here)."""
    import numpy as np
    from bilinear_tpu_torch.client import PoseClient

    out = {}
    http.start()
    try:
        client = PoseClient(f"http://{http.host}:{http.port}")
        for n in POSE_TIME_SIZES:
            frames = _pose_frames(n, SEED + 91)
            for _ in range(3):
                client.pose(frames)
            secs = []
            for _ in range(calls):
                t0 = time.perf_counter()
                client.pose(frames)
                secs.append(time.perf_counter() - t0)
            out[n] = float(np.percentile(secs, 50)) * 1e3
    finally:
        http.stop()
    return out


# ------------------------------------------------------------ phase 14

# One End2End program: n = 3 pads to 8, 21 is 8 + 8 + 5 padded to 8 (each
# size costs ~28 s of export and ~24 s of every load at full width).
AOT_E2E_SIZES = ("8",)
AOT_LIFT_ROWS = (1, 37, 300)
AOT_POSE_FRAMES = (3, 21)
# An artifact's answers against the in-process plain path on the same
# device: mean and max |d| relative to mean |ref|. Lifting runs the same
# operators (bf16 BilinearUnit; the static int8 chain) and End2End the
# standard detector; the exported graph may take another kernel of an
# operator (an addmm for a linear), so not every bit is the same.
AOT_GATES = (1e-4, 1e-2)

_AOT_CHILD = r"""
import sys, numpy as np
from bilinear_tpu_torch.io.aot import load_artifact
leaked = sorted(m for m in sys.modules if m.startswith("bilinear_tpu_torch")
                and m not in ("bilinear_tpu_torch", "bilinear_tpu_torch.io",
                              "bilinear_tpu_torch.io.aot"))
assert not leaked, leaked
inputs = np.load(sys.argv[2])
out = {}
for path in sys.argv[3:]:
    pose = load_artifact(path)
    tag = path.rsplit("/", 1)[-1]
    if pose.kind == "lifting":
        for n in sorted(int(k.split("_")[1]) for k in inputs.files
                        if k.startswith("kp_")):
            out[f"{tag}:{n}"] = pose(inputs[f"kp_{n}"])
    else:
        for n in sorted(int(k.split("_")[1]) for k in inputs.files
                        if k.startswith("frames_")):
            p2, p3 = pose(inputs[f"frames_{n}"])
            out[f"{tag}:{n}:2d"], out[f"{tag}:{n}:3d"] = p2, p3
np.savez(sys.argv[1], **out)
print("answered", len(out))
"""


def drive_aot(work):
    """cli.export_aot on the card: lifting from phase 9's checkpoint (one
    symbolic-batch bf16 program, and int8-static) and End2End from phase
    12's 2.save (bf16, batch sizes AOT_E2E_SIZES). Each artifact is loaded
    in a fresh process that imports io/aot.py alone, whose answers at
    batch sizes that need chunking and padding must match the in-process
    plain path (AOT_GATES); a ``serve --aot`` daemon of the int8-static
    lifting and the End2End artifacts answers /v1/lift and /v1/pose as the
    loaded artifacts do. Returns a record with the times."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.cli import export_aot, serve
    from bilinear_tpu_torch.client import PoseClient
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.io.checkpoint import latest_epoch, \
        load_checkpoint
    from bilinear_tpu_torch.models.bilinear import BilinearUnit
    from bilinear_tpu_torch.ops.lifting_int8 import (calibrate_scales,
                                                     forward_chain,
                                                     prepare_weights_int8)
    from bilinear_tpu_torch.serving import End2EndServer
    from bilinear_tpu_torch.serving_http import PoseHTTPServer
    from bilinear_tpu_torch.utils.weights import bilinear_from_jax

    save_root = os.path.join(work, "save")
    data_dir = os.path.join(work, "Human3.6M")
    lift_run = os.path.join(save_root, "Bilinear GT")
    serve_dir = os.path.join(work, "serve_e2e")
    out_dir = os.path.join(work, "aot")
    os.makedirs(out_dir)
    train = load_h36m(data_dir)[Task.Train]
    common = ["--data-dir", data_dir]
    paths = {t: os.path.join(out_dir, f"{t}.aot")
             for t in ("lifting", "lifting_int8", "end2end")}
    record = {"export_s": {}, "artifact_mb": {}}
    for tag, argv in (
            ("lifting", ["--kind", "lifting", "--run-dir", lift_run]),
            ("lifting_int8", ["--kind", "lifting", "--run-dir", lift_run,
                              "--quantize", "int8-static"]),
            ("end2end", ["--kind", "end2end", "--run-dir", serve_dir,
                         "--batch-sizes", *AOT_E2E_SIZES])):
        t0 = time.perf_counter()
        run_cli(export_aot.main, common + argv + ["--out", paths[tag]])
        record["export_s"][tag] = time.perf_counter() - t0
        record["artifact_mb"][tag] = os.path.getsize(paths[tag]) / 1e6
    log(f"  cli.export_aot: {record['export_s']} s; "
        f"{record['artifact_mb']} MB")

    rs = np.random.RandomState(SEED + 140)
    tree = _tree_frames(data_dir, torch.device("cuda"))
    inputs = {f"kp_{n}": (train.mean_part + train.std_part * rs.randn(
        n, 32)).astype(np.float32).reshape(n, 16, 2) for n in AOT_LIFT_ROWS}
    inputs.update({f"frames_{n}": np.take(tree, np.arange(n) % len(tree),
                                          axis=0) for n in AOT_POSE_FRAMES})
    in_path, out_path = (os.path.join(out_dir, f) for f in ("in.npz",
                                                             "out.npz"))
    np.savez(in_path, **inputs)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", _AOT_CHILD, out_path, in_path,
         *paths.values()], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)))
    record["fresh_process_s"] = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"the fresh process failed: "
                             f"{child.stderr[-4000:]}")
    got = dict(np.load(out_path))
    log(f"  a fresh process importing io/aot.py alone loaded the three "
        f"artifacts and answered {len(got)} requests in "
        f"{record['fresh_process_s']:.1f} s")

    dev = torch.device("cuda")
    payload = load_checkpoint(os.path.join(lift_run, "parameter"),
                              latest_epoch(os.path.join(lift_run,
                                                        "parameter")))
    params, stats = payload["state"]["params"], payload["state"]["batch_stats"]
    net = BilinearUnit(dtype=torch.bfloat16)
    net.load_state_dict(bilinear_from_jax(params, stats))
    net = net.to(dev).eval()
    prepared = prepare_weights_int8(params, stats, dev)
    scales = calibrate_scales(prepare_weights_int8(params, stats, "cpu"),
                              np.asarray(train.part, np.float32)[:4096])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32).reshape(-1),
                               device=dev)

    mp, sp, ms, ss = (t(a) for a in (train.mean_part, train.std_part,
                                     train.mean_s, train.std_s))
    gaps, failed = {}, []
    with torch.no_grad():
        for n in AOT_LIFT_ROWS:
            x = (torch.from_numpy(inputs[f"kp_{n}"]).to(dev).reshape(n, 32)
                 - mp) / sp
            refs = {"lifting": net(x), "lifting_int8": forward_chain(
                prepared, scales, x[None])[0]}
            for tag, y in refs.items():
                ref = (y.float() * ss + ms).reshape(n, 16, 3).cpu().numpy()
                gaps[f"{tag}:{n}"] = (got[f"{tag}.aot:{n}"], ref)
    plain = End2EndServer.from_run_dir(
        serve_dir, train, variant="torch7", dtype=torch.bfloat16,
        batch_sizes=tuple(int(b) for b in AOT_E2E_SIZES))
    for n in AOT_POSE_FRAMES:
        p2, p3 = plain.predict(inputs[f"frames_{n}"])
        gaps[f"end2end:{n}:2d"] = (got[f"end2end.aot:{n}:2d"], p2)
        gaps[f"end2end:{n}:3d"] = (got[f"end2end.aot:{n}:3d"], p3)
    record["vs_plain"] = {}
    for key, (a, ref) in gaps.items():
        d, scale = np.abs(a - ref), float(np.abs(ref).mean()) or 1.0
        rel = (float(d.mean() / scale), float(d.max() / scale))
        record["vs_plain"][key] = {"mean_rel": rel[0], "max_rel": rel[1],
                                   "bit_equal_share": float((d == 0).mean())}
        if a.shape != ref.shape or rel[0] > AOT_GATES[0] or \
                rel[1] > AOT_GATES[1]:
            failed.append(f"{key}: {rel}")
    log("  artifacts vs the in-process plain path (mean, max |d| / mean|ref|"
        f", gates {AOT_GATES}): " + "; ".join(
            f"{k} {v['mean_rel']:.2e} {v['max_rel']:.2e}"
            for k, v in record["vs_plain"].items()))
    if failed:
        raise AssertionError("artifacts off the plain path: "
                             + "; ".join(failed))

    args = serve.build_parser().parse_args(
        ["--aot", paths["lifting_int8"], paths["end2end"], "--port", "0"])
    t0 = time.perf_counter()
    http = serve.build_server(args)
    record["serve_aot_load_s"] = time.perf_counter() - t0
    http.start()
    try:
        client = PoseClient(f"http://{http.host}:{http.port}")
        health = client.health()
        lifted = client.lift(inputs["kp_37"])
        p2, p3 = client.pose(inputs["frames_3"])
    finally:
        http.stop()
    if health["lift"]["epoch"] != payload["epoch"] or \
            health["pose"]["epoch"] != 2:
        raise AssertionError(f"serve --aot health {health}")
    if not (np.array_equal(lifted, got["lifting_int8.aot:37"])
            and np.array_equal(p2, got["end2end.aot:3:2d"])
            and np.array_equal(p3, got["end2end.aot:3:3d"])):
        raise AssertionError("serve --aot answers differ from the loaded "
                             "artifacts'")
    log(f"  serve --aot daemon: /v1/lift and /v1/pose answer as the loaded "
        f"artifacts; health {health}")
    pose = _pose_p50(PoseHTTPServer(end2end=http.end2end, max_delay_ms=0))
    record["pose_http_p50_ms"] = pose
    log("  /v1/pose wall p50 through the End2End artifact (bf16, sizes "
        f"{AOT_E2E_SIZES}, u8, one request at a time): " + ", ".join(
            f"{n} frames {v:.2f} ms" for n, v in pose.items()))
    return record


# ------------------------------------------------------------ phase 15

CAMERA_POSES = 1 << 20  # x 17 joints: 71 MB of points and pixels in f32
CAMERA_GATE_PX = 1e-3  # project on the card vs project_np (FMA contraction)
UNPROJECT_GATE_MM = 0.05  # JAX's round-trip gate (tests/test_camera.py)
LEARN_TRAIN, LEARN_VALID, LEARN_RANK = 4096, 512, 5
LEARN_EPOCHS = 10
LEARN_GATE = 0.1  # MPJPE after 10 epochs below 0.1x epoch 0's
# Mean |JPEG - canvas| per image in levels of 255: quality 92 gives about
# 2, the JPEG of another canvas tens.
LEARN_JPEG_GATE = 4.0
DP_ROWS = 256  # the DP/TP equality legs: 4 steps of 64
TIME_ROWS = 1024  # the DP/TP timed legs: 16 steps of 64 an epoch
DIST_STEP_REL = 1e-5  # multi-rank vs one process: losses and digests
DIST_GRAD_REL = 1e-4  # gradient-scale leaves, of each leaf's largest
GRAD_FLOOR = 1e-3  # below this of the tree's largest: rounding noise
PP_CASES = ((2, 2), (4, 4), (8, 8))
PP_BATCH = 8
PP_TIME_ITERS = 3
MESH_SHARDS = 2
MESH_POSE_CALLS = 10  # the sharded servers' /v1/pose p50 (a depth cut)


def write_calibration(root):
    """H36M-like ``{camera}_{c,f,k,p}.txt`` for the four cameras (f ~ 1145
    px, c ~ 512 px, small k and p), from a seed."""
    import numpy as np
    from bilinear_tpu_torch.data.camera import H36M_CAMERA_IDS

    rng = np.random.RandomState(SEED)
    os.makedirs(root, exist_ok=True)
    for cid in H36M_CAMERA_IDS:
        vals = dict(f=1145.0 + rng.uniform(-5, 5, 2),
                    c=512.0 + rng.uniform(-10, 10, 2),
                    k=rng.uniform(-0.2, 0.2, 3) * np.asarray([1.0, 0.5, 0.05]),
                    p=rng.uniform(-2e-3, 2e-3, 2))
        for suffix, v in vals.items():
            np.savetxt(os.path.join(root, f"{cid}_{suffix}.txt"), v)
    return root


def check_camera(calib):
    """project on the card against project_np over CAMERA_POSES poses of
    17 joints per camera, and the unproject round trip."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.data import camera as cam_lib

    cams = cam_lib.load_all_cameras(calib)
    rng = np.random.RandomState(SEED + 15)
    pts = (rng.randn(CAMERA_POSES, 17, 3) * 300).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) + 4000
    dev_pts = torch.from_numpy(pts).cuda()
    out = {}
    for cid, cam in cams.items():
        px = cam_lib.project(dev_pts, cam)
        torch.cuda.synchronize()
        ref = cam_lib.project_np(pts, cam)
        gap = float(np.abs(px.cpu().numpy() - ref).max())
        back = cam_lib.unproject(px, dev_pts[..., 2], cam)
        rt = float((back - dev_pts).abs().max())
        ms = cuda_ms(lambda: cam_lib.project(dev_pts, cam), 5)
        log(f"  camera {cid}: project on the card vs project_np over "
            f"{CAMERA_POSES} x 17 points: max |d| {gap:.3e} px (gate "
            f"{CAMERA_GATE_PX}); unproject round trip max {rt:.3e} mm (gate "
            f"{UNPROJECT_GATE_MM}); project {ms:.3f} ms")
        if not gap <= CAMERA_GATE_PX:
            raise AssertionError(f"camera {cid}: project {gap} px")
        if not rt <= UNPROJECT_GATE_MM:
            raise AssertionError(f"camera {cid}: unproject {rt} mm")
        out[cid] = {"project_max_abs_px": gap, "unproject_max_mm": rt,
                    "project_ms": ms}
    return out


def _manifold_bins(data_dir, calib, n_train, n_valid):
    """GT bins of poses on one rank-LEARN_RANK manifold through camera
    54138969 (tests/test_learnability.py's construction)."""
    import numpy as np
    from bilinear_tpu_torch.data.camera import load_camera
    from bilinear_tpu_torch.data.h36m_generate import write_gt_bins

    struct = np.random.RandomState(1234)
    base = struct.randn(17, 3) * 150
    basis = struct.randn(LEARN_RANK, 17, 3) * 80

    def poses(n, seed):
        z = np.random.RandomState(seed).randn(n, LEARN_RANK)
        s = base[None] + np.einsum("nr,rjd->njd", z, basis)
        s[:, :, 2] += 5000.0
        return s.astype(np.float32)

    def names(n, tag):
        return [f"S1_Posing.54138969_{tag}{i:06d}.jpg" for i in range(n)]

    cam = load_camera(calib, "54138969")
    write_gt_bins(data_dir, {
        "train": {"S": poses(n_train, 0), "images": names(n_train, "t"),
                  "camera": cam},
        "valid": {"S": poses(n_valid, 1), "images": names(n_valid, "v"),
                  "camera": cam}})
    return data_dir


def drive_learnability(work, calib):
    """Bins from the camera, cli.train_bilinear at full width for
    LEARN_EPOCHS epochs, cli.valid_bilinear before and after (MPJPE below
    LEARN_GATE of epoch 0's); the learnable image tree's bins load and its
    markers sit at the projected joints (``check_learnable_markers``); the
    trained run served through
    LiftingServer (K1). Returns (record, K1 launches)."""
    import json as _json

    from bilinear_tpu_torch.cli import train_bilinear, valid_bilinear
    from bilinear_tpu_torch.data.h36m import Task, load_h36m
    from bilinear_tpu_torch.data.synthetic import \
        write_h36m_learnable_dataset
    from bilinear_tpu_torch.eval.mpjpe import evaluate_mpjpe
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.serving import LiftingServer

    data = _manifold_bins(os.path.join(work, "learn_h36m"), calib,
                          LEARN_TRAIN, LEARN_VALID)
    argv = ["--data-dir", data, "--save-root", os.path.join(work, "save"),
            "--comment", "learn", "--seed", str(SEED)]
    run_dir = os.path.join(work, "save", "learn")
    run_cli(valid_bilinear.main, argv)
    t0 = time.perf_counter()
    run_cli(train_bilinear.main, argv + ["--epochs-per-run",
                                         str(LEARN_EPOCHS)])
    secs = time.perf_counter() - t0
    run_cli(valid_bilinear.main, argv)
    mpjpe = {}
    for e in (0, LEARN_EPOCHS):
        with open(os.path.join(run_dir, f"mpjpe_epoch{e}.json")) as f:
            mpjpe[e] = _json.load(f)["overall"]
    log(f"  learnability: cli.train_bilinear {LEARN_EPOCHS} epochs of "
        f"{LEARN_TRAIN} rows in {secs:.1f} s; valid MPJPE epoch 0 "
        f"{mpjpe[0]:.2f} mm, epoch {LEARN_EPOCHS} "
        f"{mpjpe[LEARN_EPOCHS]:.2f} mm (gate < {LEARN_GATE} x epoch 0)")
    if not mpjpe[LEARN_EPOCHS] < LEARN_GATE * mpjpe[0]:
        raise AssertionError(f"lifting did not learn: {mpjpe}")

    tree = os.path.join(work, "learnable_tree")
    write_h36m_learnable_dataset(tree, n_train=24, n_valid=8,
                                 calibration_dir=calib)
    splits = load_h36m(tree, "GT")
    markers = check_learnable_markers(tree)
    log(f"  learnable tree: {len(splits[Task.Train])} + "
        f"{len(splits[Task.Valid])} frames load")
    if len(splits[Task.Train]) != 24 or len(splits[Task.Valid]) != 8:
        raise AssertionError("learnable tree: its bins did not load")

    import torch

    valid = load_h36m(data, "GT")[Task.Valid]
    server, epoch = LiftingServer.from_run_dir(
        run_dir, load_h36m(data, "GT")[Task.Train], dtype=torch.bfloat16)
    pl.LAUNCHES = 0
    _, served = evaluate_mpjpe(
        lambda x: server.lift_normalized(x), valid, chunk=LEARN_VALID)
    k1 = pl.LAUNCHES
    log(f"  served epoch {epoch} through LiftingServer (bf16): MPJPE "
        f"{served:.2f} mm against the CLI's {mpjpe[LEARN_EPOCHS]:.2f}; "
        f"{k1} K1 launches")
    if k1 < 1 or abs(served - mpjpe[LEARN_EPOCHS]) > 0.01 * \
            mpjpe[LEARN_EPOCHS]:
        raise AssertionError(f"served {served} vs {mpjpe}, {k1} launches")
    return {"mpjpe_epoch0": mpjpe[0], "mpjpe_trained": mpjpe[LEARN_EPOCHS],
            "served_mpjpe_bf16": served, "train_s": secs,
            "learnable_tree_markers": markers}, k1


def check_learnable_markers(tree):
    """The learnable tree's markers, held on its JPEG-free canvases
    (``learnable_canvases``, the arrays its JPEGs encode): each JPEG
    decodes to its canvas within LEARN_JPEG_GATE levels on average;
    stamping a frame's 16 markers again at the bins' projected joints
    leaves its canvas unchanged bit for bit (every joint of every frame),
    and stamping them 1 px to the right changes it (the check sees a 1 px
    slip); and every joint whose rounded pixel no later marker covers
    carries its white centre there."""
    import numpy as np
    from PIL import Image
    from bilinear_tpu_torch.data.synthetic import _joint_colors, \
        _stamp_marker, learnable_canvases

    colors = _joint_colors()
    joints = same = moved = visible = white = 0
    jpeg = 0.0
    for path, canvas, xy, ring in learnable_canvases(tree):
        decoded = np.asarray(Image.open(path)).astype(np.float64)
        jpeg = max(jpeg, float(np.abs(decoded - canvas).mean()))
        for shift, counter in ((0.0, "same"), (1.0, "moved")):
            again = canvas.copy()
            for m, (x, y) in enumerate(xy):
                _stamp_marker(again, float(x) + shift, float(y), m, ring,
                              colors)
            equal = bool(np.array_equal(again, canvas))
            if counter == "same":
                same += 16 * equal
            else:
                moved += 16 * (not equal)
        joints += 16
        h, w, _ = canvas.shape
        for m, (px, py) in enumerate(np.rint(xy).astype(int)):
            later = xy[m + 1:]
            d2 = (px - later[:, 0]) ** 2 + (py - later[:, 1]) ** 2
            if (d2 <= (5 * ring) ** 2).any() or not (0 <= px < w
                                                      and 0 <= py < h):
                continue
            visible += 1
            white += int((canvas[py, px] == 255).all())
    log(f"  learnable tree markers on the JPEG-free canvases: {same} of "
        f"{joints} joints re-stamped in place bit for bit, {moved} of "
        f"{joints} moved by a 1 px shift; {white} of {visible} joints that "
        f"no later marker covers carry the white centre; JPEG vs canvas "
        f"mean |d| at most {jpeg:.3f} levels (gate {LEARN_JPEG_GATE})")
    if not (same == moved == joints > 0 and white == visible > 0
            and jpeg <= LEARN_JPEG_GATE):
        raise AssertionError(f"learnable tree markers: {same}, {moved}, "
                             f"{white}/{visible}, {jpeg} of {joints}")
    return {"joints": joints, "restamped_in_place": same,
            "moved_by_1px": moved, "white_centres": [white, visible],
            "jpeg_mean_abs_max": jpeg}


_PORTS_GIVEN = set()


def _free_port():
    """A free localhost port for a process group's coordinator, below the
    kernel's ephemeral range: a rank's coordinator listens seconds after
    this call, while the ranks of other legs open connections, and an
    ephemeral port could be handed to one of those meanwhile. Never the
    same port twice in one process."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random()
    while True:
        port = rng.randrange(max(1024, low - 10000), low)
        if port in _PORTS_GIVEN:
            continue
        s = socket.socket()
        try:
            s.bind(("localhost", port))
        except OSError:
            continue
        finally:
            s.close()
        _PORTS_GIVEN.add(port)
        return port


def _ranks(module, argv, world, expect_ok=True, timeout=900):
    """``python -m module argv --coordinator ...`` as ``world`` ranks on
    this card; returns their stderr. Every rank is waited for."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--coordinator",
         f"localhost:{port}", "--num-processes", str(world),
         "--process-id", str(r)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=timeout)
        errs.append(err)
        if expect_ok and p.returncode != 0:
            raise AssertionError(f"{module} rank failed: {err[-3000:]}")
        if not expect_ok and p.returncode == 0:
            raise AssertionError(f"{module} rank should have failed")
    return errs


def _save_digests(run_dir, end2end=False):
    """A run's 1.save (its trees, as ``payload``), epoch 1's logged loss,
    digests (sum |params|, sum |BN means|), parameter files and log
    (train_end2end's: its line reads ``saved (loss X = hm ...``)."""
    import numpy as np
    from bilinear_tpu_torch.io.checkpoint import load_checkpoint

    pdir = os.path.join(run_dir, "parameter")
    payload = load_checkpoint(pdir, 1)
    params = sum(float(np.abs(v).sum())
                 for v in _flat(payload["state"]["params"]).values())
    means = sum(float(np.abs(v).sum()) for k, v in
                _flat(payload["state"]["batch_stats"]).items()
                if k.endswith("/mean"))
    with open(os.path.join(run_dir, "debug.log")) as f:
        text = f.read()
    # epoch 1's loss, the step whose 1.save is compared
    if end2end:
        loss = [float(ln.split("saved (loss ")[1].split(" ")[0])
                for ln in text.splitlines()
                if "Epoch 1 saved (loss " in ln][0]
    else:
        loss = _log_value(text, "Epoch 1 saved (loss:", "loss: ")[0]
    return {"loss": loss, "params_abs_sum": params, "bn_mean_abs_sum": means,
            "payload": payload, "files": sorted(os.listdir(pdir)),
            "log": text}


def _flat(tree, prefix=""):
    """{path: float64 array} of a nested dict's leaves."""
    import numpy as np

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _leaf_gap(got, ref, floor=0.0):
    """Each leaf's max |got - ref| / max |ref|: (the largest, its leaf,
    the leaves not compared). A leaf whose
    max |ref| is below ``floor`` of the tree's largest is not compared: a
    gradient that is zero in exact arithmetic (the bias in front of a
    train-mode BN) is rounding noise on both sides."""
    import numpy as np

    g, r = _flat(got), _flat(ref)
    if sorted(g) != sorted(r):
        raise AssertionError(f"trees differ: {sorted(set(g) ^ set(r))}")
    top = max(float(np.abs(v).max()) for v in r.values() if v.size)
    gaps = {}
    for k, want in r.items():
        scale = float(np.abs(want).max()) if want.size else 0.0
        if scale >= floor * top and want.size:
            gaps[k] = float(np.abs(g[k] - want).max()) / max(scale, 1e-30)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, len(r) - len(gaps)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _square_avg_rels(got, ref):
    """Per tensor |g_a - g_b| / |g_b| of |g| = 10 sqrt(square_avg) (one
    RMSprop step), sorted, every conv bias but the heatmap heads' left out
    (a train-mode BN removes its shift); and the count of tensors."""
    import numpy as np

    g_abs, r_abs = ({k: np.sqrt(v) for k, v in
                     _flat(run["payload"]["optimizer"]["1"]["square_avg"])
                     .items()} for run in (got, ref))
    gated = [k for k in r_abs if not (k.endswith("/bias") and
                                      k[:-4] + "kernel" in r_abs
                                      and not re.match(r"htmap_\d+/", k))]
    return sorted((float(np.linalg.norm(g_abs[k] - r_abs[k])
                         / max(np.linalg.norm(r_abs[k]), 1e-30)), k)
                  for k in gated), len(r_abs)


def _held_to(name, got, ref, adam, files=("1.save",)):
    """A multi-rank run against the one-process run on the card, leaf by
    leaf. Gated: loss and digests within DIST_STEP_REL, and the
    gradients. The lifter's (Adam's mu, of the leaves above GRAD_FLOOR of
    the tree's largest) each within DIST_GRAD_REL of its leaf's largest.
    The detector's f32 gradients at a random state are ill-conditioned
    (ROADMAP.md Queue 3; the CPU tests hold them in float64), so they get
    phase 7's gates for two f32 evaluations of its step in another order
    (PARITY_F32: median and 90th percentile over tensors of |g_a - g_b| /
    |g_b|, here of |g| = 10 sqrt(square_avg), every conv bias but the
    heatmap heads' left out: a train-mode BN removes its shift), and its
    first step's BN statistics each within DIST_STEP_REL of its leaf's
    largest. Reported, not gated: the largest gradient gaps, and after
    Adam the parameters and BN statistics per leaf (Adam moves an element
    whose gradient is near eps by up to lr on rounding alone, and cuBLAS
    rounds a row differently at another batch or width, so after the
    first step these gaps measure that amplification, not the split)."""
    import numpy as np

    def trees(run):
        state, opt = run["payload"]["state"], run["payload"]["optimizer"]
        return state["params"], state["batch_stats"], opt["1"]

    gaps = {k: _rel(got[k], ref[k])
            for k in ("loss", "params_abs_sum", "bn_mean_abs_sum")}
    gates = dict.fromkeys(gaps, DIST_STEP_REL)
    (gp, gs, go), (rp, rs, ro) = trees(got), trees(ref)
    stats, stats_at, _ = _leaf_gap(gs, rs)
    reported = {"bn_stats_leaf_worst": [stats, stats_at]}
    if adam:
        worst, where, noise = _leaf_gap(go["mu"], ro["mu"],
                                        floor=GRAD_FLOOR)
        gaps["grad_leaf"], gates["grad_leaf"] = worst, DIST_GRAD_REL
        reported["params_leaf_worst"] = list(_leaf_gap(gp, rp)[:2])
        compared = f"{len(_flat(ro['mu'])) - noise} of {len(_flat(ro['mu']))}"
    else:
        rel, n_all = _square_avg_rels(got, ref)
        q = _quantiles(rel)
        gaps["grad_rel_median"], gaps["grad_rel_p90"] = q[0.5], q[0.9]
        gates["grad_rel_median"], gates["grad_rel_p90"] = PARITY_F32[1:]
        gaps["bn_stats_leaf"], gates["bn_stats_leaf"] = stats, DIST_STEP_REL
        reported["grad_rel_max"] = list(rel[-1])
        compared = f"{len(rel)} of {n_all}"
    log(f"  {name}: loss {got['loss']:.6f} (one process {ref['loss']:.6f}); "
        "gaps " + ", ".join(f"{k} {v:.2e} (gate {gates[k]})"
                            for k, v in gaps.items())
        + "; reported: " + ", ".join(f"{k} {v:.2e} at {at}"
                                     for k, (v, at) in reported.items())
        + f"; {compared} gradient tensors compared; files {got['files']}")
    if got["files"] != list(files) or any(gaps[k] > gates[k] for k in gaps):
        raise AssertionError(f"{name}: {gaps} (gates {gates}), "
                             f"{got['files']}")
    return dict(gaps, gates=gates, reported=reported)


def _epoch_step_ms(text):
    """ms per step of the last epoch logged by cli.train_bilinear."""
    line = [ln for ln in text.splitlines() if "saved (loss:" in ln][-1]
    steps, secs = re.search(r"(\d+) steps in ([0-9.]+) s", line).groups()
    return float(secs) * 1e3 / int(steps)


def drive_parallel_training(work, calib, card):
    """Phase 15's multi-rank legs on this one card, every rank a process
    started through the CLI's --coordinator flags (gloo: the ranks share
    the card): train_bilinear DP (2 ranks), TP (data 1 x model 2) and
    DP x TP (2 x 2) for one epoch of DP_ROWS rows, each against one
    process; a full-width standard train_hourglass step over 2 ranks (4
    rows each) against one process; a one-rank NCCL train_bilinear. These
    equality legs run side by side (their answers do not depend on the
    schedule; the seconds they take together are no measure of any one).
    Then the DP run's 1.save resumed by one process, and ms per step with
    two ranks sharing the card, each timed leg alone."""
    from bilinear_tpu_torch.cli import train_bilinear, train_hourglass
    from bilinear_tpu_torch.data.synthetic import write_mpii_dataset

    out = {}
    data = _manifold_bins(os.path.join(work, "dp_h36m"), calib, DP_ROWS, 64)
    lift = ["--data-dir", data, "--epochs-per-run", "1", "--seed",
            str(SEED), "--comment", "lift"]
    mpii = os.path.join(work, "dp_mpii")
    write_mpii_dataset(mpii, n_train_images=8, n_test_images=1,
                       learnable=True, seed=SEED)
    hg = ["--data-dir", mpii, "--batch-size", "8", "--epochs-per-run", "1",
          "--steps-per-dispatch", "1", "--comment", "hg", "--seed",
          str(SEED)]
    lift_legs = (("bilinear_dp_2", 2, 1), ("bilinear_tp_1x2", 2, 2),
                 ("bilinear_dp_tp_2x2", 4, 2))
    t0 = time.perf_counter()
    legs = {name: _Ranks("train_bilinear", lift + [
        "--save-root", os.path.join(work, name), "--model-parallel",
        str(model)], world) for name, world, model in lift_legs}
    legs["nccl"] = _Ranks("train_bilinear", lift + [
        "--save-root", os.path.join(work, "nccl")], 1)
    legs["hg_dp"] = _Ranks("train_hourglass",
                           hg + ["--save-root", os.path.join(work, "hg_dp")],
                           2)
    try:
        one_root = os.path.join(work, "dp_one")
        run_cli(train_bilinear.main, lift + ["--save-root", one_root])
        ref = _save_digests(os.path.join(one_root, "lift"))
        hg_root = os.path.join(work, "hg_one")
        run_cli(train_hourglass.main, hg + ["--save-root", hg_root])
        hg_ref = _save_digests(os.path.join(hg_root, "hg"))
        for ranks in legs.values():
            ranks.collect()
    finally:
        for ranks in legs.values():
            for proc in ranks.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    out["equality_legs_side_by_side_s"] = time.perf_counter() - t0
    for name, _, _ in lift_legs:
        got = _save_digests(os.path.join(work, name, "lift"))
        if "backend gloo" not in got["log"]:
            raise AssertionError(f"{name}: not on gloo")
        out[name] = {"gaps": _held_to(name, got, ref, adam=True)}
    got = _save_digests(os.path.join(work, "nccl", "lift"))
    if "backend nccl" not in got["log"]:
        raise AssertionError("the one-rank run did not take NCCL")
    out["bilinear_nccl_1"] = {"gaps": _held_to("bilinear_nccl_1", got, ref,
                                                adam=True)}
    got = _save_digests(os.path.join(work, "hg_dp", "hg"))
    out["hourglass_dp_2"] = {"gaps": _held_to("hourglass DP 2 ranks, full "
                                              "width, standard", got,
                                              hg_ref, adam=False)}
    log(f"  the equality legs (DP, TP, DP x TP, NCCL, the detector's DP "
        f"step: 11 processes) side by side in "
        f"{out['equality_legs_side_by_side_s']:.1f} s")
    # The DP run's 1.save resumes in one process.
    dp_root = os.path.join(work, "bilinear_dp_2")
    run_cli(train_bilinear.main, lift + ["--save-root", dp_root])
    with open(os.path.join(dp_root, "lift", "debug.log")) as f:
        text = f.read()
    if "Resumed from epoch 1" not in text or not os.path.exists(
            os.path.join(dp_root, "lift", "parameter", "2.save")):
        raise AssertionError("the DP 1.save did not resume in one process")
    log("  the DP run's 1.save resumed in one process (2.save written)")

    # Times, each leg alone: two epochs of TIME_ROWS manifold rows, the
    # second's ms per step; one process (this one) on the same epochs.
    timed = _manifold_bins(os.path.join(work, "time_h36m"), calib, TIME_ROWS,
                           64)
    timed_argv = ["--data-dir", timed, "--epochs-per-run", "2", "--comment",
                  "t"]
    for name, world, model in (("one_process", 1, 0), ("dp_2", 2, 1),
                               ("tp_1x2", 2, 2)):
        root = os.path.join(work, "time_" + name)
        if world == 1:
            run_cli(train_bilinear.main, timed_argv + ["--save-root", root])
        else:
            _ranks("bilinear_tpu_torch.cli.train_bilinear",
                   timed_argv + ["--save-root", root, "--model-parallel",
                                 str(model)], world)
        with open(os.path.join(root, "t", "debug.log")) as f:
            out[name + "_ms_per_step"] = _epoch_step_ms(f.read())
    log(f"  lifting train step, batch 64, f32, ms per step on {card}: one "
        f"process {out['one_process_ms_per_step']:.3f}, DP 2 ranks "
        f"{out['dp_2_ms_per_step']:.3f}, TP 1x2 "
        f"{out['tp_1x2_ms_per_step']:.3f} (each alone, epoch 2 of two "
        f"{TIME_ROWS // 64}-step epochs; two ranks share one card over gloo: "
        "not a scaling figure)")
    # --fused-blocks true over the same ranks is phase 16's run.
    return out


def _mesh(n=MESH_SHARDS):
    return ["cuda:0"] * n


def drive_mesh_serving(work):
    """LiftingServer and End2EndServer over a local mesh of this card
    twice, against the unsharded servers; K1/K2, K3-eval and K6/K7
    launches per call; times. Returns (record, launches by kernel)."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.models.end2end import End2End
    from bilinear_tpu_torch.ops import lifting as pl
    from bilinear_tpu_torch.ops import lifting_int8 as pq
    from bilinear_tpu_torch.serving import End2EndServer, LiftingServer
    from bilinear_tpu_torch.serving_http import PoseHTTPServer
    from bilinear_tpu_torch.utils import weights as wt
    from bilinear_tpu_torch.utils.weights import bilinear_to_jax

    out = {"lifting": {}, "end2end": {}}
    launches = {}
    params, stats = bilinear_to_jax(random_state_dict(SEED))
    ident = (np.zeros(32), np.ones(32), np.zeros(48), np.ones(48))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 151)
    x = torch.randn((511, 32), generator=gen, device="cuda")
    big = torch.randn((65536, 32), generator=gen, device="cuda")
    for mode, quantize, kernel in (("bf16", None, "lifting_bf16"),
                                   ("int8", "int8", "lifting_int8_dynamic"),
                                   ("int8-static", "int8-static",
                                    "lifting_int8_static")):
        kw = dict(dtype=torch.bfloat16, quantize=quantize)
        flat = LiftingServer(params, stats, *ident, device="cuda", **kw)
        mesh = LiftingServer(params, stats, *ident, mesh=_mesh(), **kw)
        mesh.lift_normalized(x)
        pl.LAUNCHES = pq.LAUNCHES = 0
        got = mesh.lift_normalized(x)
        torch.cuda.synchronize()
        n_launch = pl.LAUNCHES if quantize is None else pq.LAUNCHES
        launches[kernel] = n_launch
        pad = torch.cat([x, x.new_zeros((1, 32))])
        blocks = torch.cat([flat.lift_normalized(b) for b in pad.chunk(2)])
        per_block = bool(torch.equal(got, blocks[:511]))
        whole = bool(torch.equal(got, flat.lift_normalized(x)))
        t_mesh = cuda_ms(lambda: mesh.lift_normalized(big), 10)
        t_flat = cuda_ms(lambda: flat.lift_normalized(big), 10)
        log(f"  LiftingServer {mode} over {MESH_SHARDS} shards of cuda:0, "
            f"511 rows: {n_launch} launches; equal to the unsharded server "
            f"on each shard's rows: {per_block}, on the whole batch: "
            f"{whole}; lift_normalized at 65536 rows {t_mesh:.4f} ms "
            f"sharded, {t_flat:.4f} unsharded")
        if n_launch != MESH_SHARDS or not per_block or \
                (quantize is None and not whole):
            raise AssertionError(f"mesh lifting {mode}")
        out["lifting"][mode] = {"launches_per_call": n_launch,
                                "bit_equal_per_shard": per_block,
                                "bit_equal_whole_batch": whole,
                                "ms_65536_sharded": t_mesh,
                                "ms_65536_unsharded": t_flat}

    model = End2End(generator=torch.Generator().manual_seed(SEED + 152))
    variables = dict(zip(("params", "batch_stats"),
                         wt.end2end_to_jax(model.state_dict(), "torch7")))
    frames = _pose_frames(16, SEED + 153)
    for label, quantize, model_kw in (("bf16_fused", None, {"fused": True}),
                                      ("int8", "int8", {})):
        kw = dict(variant="torch7", dtype=torch.bfloat16,
                  batch_sizes=(2, 4, 8, 16), model_kw=model_kw,
                  quantize=quantize)
        flat = End2EndServer(variables, *ident, device="cuda", **kw)
        mesh = End2EndServer(variables, *ident, mesh=_mesh(), **kw)
        rec = {}
        for n in (8, 16):
            mesh.predict(frames[:n])
            _zero_res_counts()
            _zero_int8_counts()
            p2, p3 = mesh.predict(frames[:n])
            torch.cuda.synchronize()
            res, q = _res_counts(), _int8_counts()
            q2 = np.concatenate([flat.predict(b)[0] for b in
                                 np.split(frames[:n], MESH_SHARDS)])
            q3 = np.concatenate([flat.predict(b)[1] for b in
                                 np.split(frames[:n], MESH_SHARDS)])
            w2, w3 = flat.predict(frames[:n])
            per_block = bool(np.array_equal(p2, q2) and
                             np.array_equal(p3, q3))
            g2, g3 = _pose_gap(p2, w2), _pose_gap(p3, w3)
            whole = bool(np.array_equal(p2, w2) and np.array_equal(p3, w3))
            rec[n] = {"resmodule_fwd_eval": res["resmodule_fwd_eval"],
                      "int8_quantize": q["int8_quantize"],
                      "int8_conv": q["int8_conv"],
                      "bit_equal_per_shard": per_block,
                      "bit_equal_whole_batch": whole,
                      "pose2d_gap_px_median_max": g2,
                      "pose3d_gap_mm_median_max": g3}
            log(f"  End2EndServer {label} over {MESH_SHARDS} shards, {n} "
                f"frames: K3 eval {res['resmodule_fwd_eval']}, K6 "
                f"{q['int8_quantize']}, K7 {q['int8_conv']} launches; equal "
                f"to the unsharded server on each shard's frames: "
                f"{per_block}; against its whole batch: bit-equal {whole}, "
                f"pose2d median/max {g2[0]:.2e}/{g2[1]:.2e} px, pose3d "
                f"{g3[0]:.2e}/{g3[1]:.2e} mm (gate {POSE_SELF_GATE})")
            want = (107 * MESH_SHARDS, 0, 0) if quantize is None else \
                (0, 321 * MESH_SHARDS, 321 * MESH_SHARDS)
            if (res["resmodule_fwd_eval"], q["int8_quantize"],
                    q["int8_conv"]) != want or not per_block or \
                    max(g2[1], g3[1]) > POSE_SELF_GATE:
                raise AssertionError(f"mesh End2End {label} at {n}")
            if quantize is None:
                launches["resmodule_fwd_eval"] = launches.get(
                    "resmodule_fwd_eval", 0) + res["resmodule_fwd_eval"]
            else:
                for k in ("int8_quantize", "int8_conv"):
                    launches[k] = launches.get(k, 0) + q[k]
        rec["pose_http_p50_ms"] = _pose_p50(PoseHTTPServer(
            end2end=mesh, max_delay_ms=0), MESH_POSE_CALLS)
        log(f"  /v1/pose wall p50, {label}, {MESH_SHARDS} shards of cuda:0, "
            "u8, one request at a time: " + ", ".join(
                f"{n} frames {v:.2f} ms"
                for n, v in rec["pose_http_p50_ms"].items()))
        out["end2end"][label] = rec
    return out, launches


def _stack_res_modules(model):
    """(ResModules of the stem, of one stack) of a MainModel."""
    from bilinear_tpu_torch.models.hourglass_torch7 import ResModule

    def count(mods):
        return sum(isinstance(m, ResModule) for mm in mods
                   for m in mm.modules())

    return count([model.beforeHourglass]), count(model.stack_modules(0))


def drive_pipeline():
    """pipeline_forward at full width over ["cuda:0"] * S, (S, M) in
    PP_CASES, batch PP_BATCH: fused bf16 against MainModel(fused=True)
    (phase 3b's K3 eval gate; bit-equality reported) with its K3-eval
    launches; int8 against the int8 MainModel with its K6/K7 launches;
    pipeline_end2end against End2End; one make_pp_train_step at (2, 2)
    against the one-process step accumulated over the same microbatches;
    forward times. Returns (record, launches by kernel)."""
    import torch
    from bilinear_tpu_torch.models.end2end import End2End
    from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
    from bilinear_tpu_torch.parallel import pp

    out = {"fused_bf16": {}, "int8": {}}
    launches = {"resmodule_fwd_eval": 0, "int8_quantize": 0, "int8_conv": 0}
    gen = torch.Generator().manual_seed(SEED + 161)
    fused = MainModel(fused=True, dtype=torch.bfloat16,
                      generator=gen).cuda().eval()
    q8 = MainModel(quantize="int8", dtype=torch.bfloat16).cuda().eval()
    q8.load_state_dict(fused.state_dict())
    stem_res, stack_res = _stack_res_modules(fused)
    images = torch.rand((PP_BATCH, 256, 256, 3),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(SEED + 162), device="cuda")
    with torch.no_grad():
        ref = fused(images)[-1]
        ref_q = q8(images)[-1]
    gates = RES_GATES[("K3", "bf16")]
    for s, m in PP_CASES:
        for label, model, want_ref in (("fused_bf16", fused, ref),
                                       ("int8", q8, ref_q)):
            fn = pp.make_pipeline_fn(model, _mesh(s), microbatches=m)
            fn(images)
            _zero_res_counts()
            _zero_int8_counts()
            got = fn(images)
            torch.cuda.synchronize()
            res, q = _res_counts(), _int8_counts()
            equal = bool(torch.equal(got, want_ref))
            mx, mean = gate_close(f"PP {label} (S, M) = ({s}, {m})", got,
                                  want_ref, *gates)
            t_pp = cuda_ms(lambda: fn(images), PP_TIME_ITERS)
            with torch.no_grad():
                t_one = cuda_ms(lambda: model(images), PP_TIME_ITERS)
            if label == "fused_bf16":
                n = res["resmodule_fwd_eval"]
                want_n = stem_res + stack_res * model.n_stacks * m
                launches["resmodule_fwd_eval"] += n
                counts = {"resmodule_fwd_eval": n}
                ok = n == want_n and q["int8_conv"] == 0
            else:
                want_n = 3 * (stem_res + stack_res * model.n_stacks * m)
                for k in ("int8_quantize", "int8_conv"):
                    launches[k] += q[k]
                counts = dict(q)
                # K6/K7 and the float ops between them act per sample:
                # a microbatch's rows are the whole batch's bits.
                ok = q["int8_quantize"] == q["int8_conv"] == want_n and \
                    res["resmodule_fwd_eval"] == 0 and equal
            log(f"  PP {label} (S, M) = ({s}, {m}): launches {counts} "
                f"(want {want_n} = the stem's once, the stacks' once per "
                f"microbatch); bit-equal to MainModel on the whole batch: "
                f"{equal}; forward {t_pp:.2f} ms against MainModel's "
                f"{t_one:.2f} ms")
            if not ok:
                raise AssertionError(f"PP {label} ({s}, {m}) launches "
                                     f"{counts}, want {want_n}")
            out[label][f"{s}x{m}"] = {
                "launches": counts, "bit_equal": equal, "max_abs": mx,
                "mean_abs": mean, "ms": t_pp, "main_model_ms": t_one}

    e2e = End2End(fused=True, dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(SEED + 163)) \
        .cuda().eval()
    centers = torch.full((PP_BATCH, 2), 128.0, device="cuda")
    scales = torch.full((PP_BATCH,), 1.28, device="cuda")
    mean_p = torch.zeros(32, device="cuda")
    std_p = torch.ones(32, device="cuda")
    p2, p3 = pp.pipeline_end2end(e2e, images, centers, scales, mean_p,
                                 std_p, _mesh(2), microbatches=2)
    with torch.no_grad():
        _, q2, q3 = e2e(images, centers, scales, mean_p, std_p)
    g2 = _pose_gap(p2.cpu().numpy(), q2.cpu().numpy())
    g3 = _pose_gap(p3.reshape(-1, 16, 3).float().cpu().numpy(),
                   q3.reshape(-1, 16, 3).float().cpu().numpy())
    log(f"  pipeline_end2end (2, 2) against End2End, fused bf16: pose2d "
        f"median/max {g2[0]:.2e}/{g2[1]:.2e} px, normalized 3D "
        f"{g3[0]:.2e}/{g3[1]:.2e} (gate {POSE_SELF_GATE}); bit-equal "
        f"{bool(torch.equal(p2, q2) and torch.equal(p3, q3))}")
    if max(g2[1], g3[1]) > POSE_SELF_GATE:
        raise AssertionError("pipeline_end2end")
    out["end2end"] = {"pose2d_gap_px": g2, "pose3d_gap": g3}

    out["train_step_2x2"] = pp_train_parity(images)
    return out, launches


def pp_train_parity(images):
    """One make_pp_train_step at (S, M) = (2, 2), full width, f32, the
    standard model, against the one-process step with gradients
    accumulated over the same two microbatches: loss rel 1e-5; clipped
    gradients per leaf within 1e-3 of the leaf's largest value at the
    median over leaves (phase 7's measure); parameters where |g| > 3e-5 at
    JAX's amplified gate (rtol 2e-3, atol 2e-4; RMSprop's first step is 10
    lr sign(g))."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.core.optim import hourglass_optimizer
    from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
    from bilinear_tpu_torch.parallel import pp
    from bilinear_tpu_torch.train.hourglass import heatmap_loss

    gen = torch.Generator().manual_seed(SEED + 171)
    a = MainModel(generator=gen).cuda()
    b = MainModel().cuda()
    b.load_state_dict(a.state_dict())
    targets = torch.rand((PP_BATCH, 16, 64, 64),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(SEED + 172), device="cuda")
    step = pp.make_pp_train_step(a, _mesh(2), microbatches=2)
    loss = float(step(images, targets))
    opt = hourglass_optimizer(b.parameters())
    b.train()
    opt.zero_grad()
    total = 0.0
    for xm, tm in zip(images.chunk(2), targets.chunk(2)):
        lm = heatmap_loss(b(xm), tm) / 2
        lm.backward()
        total += float(lm.detach())
    opt.step()
    ga = dict(a.named_parameters())
    rel, bad = [], 0
    checked = 0
    sb = b.state_dict()
    for k, p in b.named_parameters():
        if p.grad is None:
            continue
        scale = float(p.grad.abs().max())
        if scale > 1e-6:  # a conv bias before a BN is noise on both sides
            rel.append(float((ga[k].grad - p.grad).abs().max()) / scale)
        m = p.grad.abs() > 3e-5
        got, want = ga[k].detach()[m], sb[k][m]
        checked += int(m.sum())
        bad += int(((got - want).abs() > 2e-4 + 2e-3 * want.abs()).sum())
    med, worst = float(np.median(rel)), float(np.max(rel))
    log(f"  PP train step (2, 2), full width, f32: loss {loss:.6f} against "
        f"the accumulated one-process step's {total:.6f} (rel "
        f"{_rel(loss, total):.2e}, gate 1e-5); clipped gradients per leaf, "
        f"|d| / max|g|: median {med:.2e} (gate 1e-3), max {worst:.2e}; "
        f"parameters where |g| > 3e-5: {bad} of {checked} outside rtol "
        "2e-3 / atol 2e-4")
    if _rel(loss, total) > 1e-5 or med > 1e-3 or bad:
        raise AssertionError("PP train step parity")
    return {"loss": loss, "accumulated_loss": total, "grad_median": med,
            "grad_max": worst, "params_outside": bad}


def drive_phase15(card):
    """Phase 15: camera and bins, DP/TP training, mesh serving, PP.
    Returns (record, launches by kernel and path)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_15_")
    t0 = time.perf_counter()

    def step(text):
        log(f"{text} (phase 15 at {time.perf_counter() - t0:.1f} s)")

    try:
        calib = write_calibration(os.path.join(work, "calibration"))
        step(f"phase 15a: the camera on {card}")
        rec = {"camera": check_camera(calib)}
        step("phase 15b: bins, and a lifter that learns from them")
        rec["learnability"], k1_learn = drive_learnability(work, calib)
        step(f"phase 15c: DP and TP training, ranks sharing {card}")
        rec["parallel_training"] = drive_parallel_training(work, calib,
                                                           card)
        step(f"phase 15d: mesh-sharded serving on {card}")
        rec["mesh_serving"], mesh_launches = drive_mesh_serving(work)
        step(f"phase 15e: pipeline parallelism at full width on {card}")
        rec["pipeline"], pp_launches = drive_pipeline()
        step("phase 15: done")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {"lifting_bf16": {"phase15_serving_the_learned_lifter":
                                 k1_learn}}
    for k, n in mesh_launches.items():
        launches.setdefault(k, {})["phase15_mesh_serving"] = n
    for k, n in pp_launches.items():
        launches.setdefault(k, {})["phase15_pipeline_forward"] = n
    return rec, launches


def phase15_alone() -> int:
    """Phases 1, 2 and 15 only: a quick loop on phase 15 (``python3 -c
    "import chip_smoke; chip_smoke.phase15_alone()"``)."""
    import torch
    from bilinear_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = _build.build_all(["lifting", "lifting_int8", "resmodule",
                             "int8_conv"])
    log(f"card: {card}; built in {secs:.1f} s")
    t0 = time.perf_counter()
    rec, launches = drive_phase15(card)
    log(json.dumps({"phase15": rec, "launches": launches}))
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return 0


# ------------------------------------------------------------ phase 16

P16_TRAIN_IMAGES = 8  # 7 train records: one step of 3 + 4 rows per epoch
P16_CUT_STACKS = 2  # the preemption and --debug-nans legs' depth cut
# (their width is full)


def _stage_counts():
    from bilinear_tpu_torch.ops import resmodule as rm

    return {"resmodule_fwd_stages": rm.LAUNCHES_FWD_STAGES,
            "resmodule_bwd_stages": rm.LAUNCHES_BWD_STAGES}


def _zero_stage_counts():
    from bilinear_tpu_torch.ops import resmodule as rm

    rm.LAUNCHES_FWD_STAGES = rm.LAUNCHES_BWD_STAGES = 0


class _StepTimer:
    """Wraps ``HourglassTrainer.train_step`` while active: each step's ms
    (synchronised before and after)."""

    def __init__(self):
        self.ms = []

    def __enter__(self):
        import torch
        from bilinear_tpu_torch.train import hourglass as th

        self._real = real = th.HourglassTrainer.train_step
        ms = self.ms

        def timed(trainer, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(trainer, *a, **k)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return out

        th.HourglassTrainer.train_step = timed
        return self

    def __exit__(self, *exc):
        from bilinear_tpu_torch.train import hourglass as th

        th.HourglassTrainer.train_step = self._real
        return False


def rank_main() -> int:
    """One rank (or the one process) of a phase-16 subprocess leg: ``python3
    -c "import chip_smoke, sys; sys.exit(chip_smoke.rank_main())" CLI
    ARGS...``, CLI a module of bilinear_tpu_torch.cli. Its environment
    plants what a leg asks for: SMOKE_SKIP_EXCHANGE (the first exchange of
    every staged K3 call returns this rank's row alone: rank-local
    statistics for the block's first BN), SMOKE_SIGNAL_RANK (that rank
    sends itself SIGTERM inside epoch 1). Prints one line ``SMOKE_COUNTS
    {json}`` on stderr: the K3/K4 launches and stage entries, and each
    step's ms."""
    import importlib
    import signal

    import torch
    from bilinear_tpu_torch.ops import resmodule as rk
    from bilinear_tpu_torch.train import hourglass as th

    cli, argv = sys.argv[1], sys.argv[2:]
    rank = int(argv[argv.index("--process-id") + 1]) \
        if "--process-id" in argv else 0
    if os.environ.get("SMOKE_SKIP_EXCHANGE"):
        make = rk.group_exchange

        def faulty(group, rows):
            ex, calls = make(group, rows), [0]

            def gather(row):
                calls[0] += 1
                return row[None] if calls[0] == 1 else ex.gather(row)

            return rk.RankExchange(gather, rows)

        rk.group_exchange = faulty
    if os.environ.get("SMOKE_SIGNAL_RANK", "") == str(rank):
        fit = th.HourglassTrainer.fit_epoch

        def fit_epoch(self, state, pipeline, epoch, *a, **k):
            if epoch == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return fit(self, state, pipeline, epoch, *a, **k)

        th.HourglassTrainer.fit_epoch = fit_epoch
    _zero_res_counts()
    _zero_stage_counts()
    with _StepTimer() as timer:
        importlib.import_module(f"bilinear_tpu_torch.cli.{cli}").main(argv)
    print("SMOKE_COUNTS " + json.dumps(dict(_res_counts(), **_stage_counts(),
                                            step_ms=timer.ms)),
          file=sys.stderr)
    return 0


class _Ranks:
    """``cli``'s main as ``world`` ranks on this card through ``rank_main``,
    started at once (with --coordinator when ``world`` > 0; 0 is one
    process without it); their output goes to files, so legs can run side
    by side. ``collect`` waits for every rank and returns each one's
    (counts or None, stderr, return code)."""

    def __init__(self, cli, argv, world, env=None):
        self.cli = cli
        port = _free_port()
        extra = ["--coordinator", f"localhost:{port}", "--num-processes",
                 str(world)] if world else []
        self.logs, self.procs = [], []
        for r in range(max(world, 1)):
            log_file = tempfile.TemporaryFile(mode="w+")
            self.logs.append(log_file)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import chip_smoke, sys; sys.exit(chip_smoke.rank_main())",
                 cli, *argv, *extra,
                 *(["--process-id", str(r)] if world else [])],
                cwd=ROOT, env=dict(os.environ, **(env or {})),
                stdout=subprocess.DEVNULL, stderr=log_file, text=True))

    def collect(self, expect_ok=True, timeout=600):
        out = []
        for p, log_file in zip(self.procs, self.logs):
            try:
                p.wait(timeout=timeout)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            log_file.seek(0)
            err = log_file.read()
            log_file.close()
            if expect_ok and p.returncode != 0:
                raise AssertionError(f"{self.cli} rank failed: "
                                     f"{err[-3000:]}")
            line = [ln for ln in err.splitlines()
                    if ln.startswith("SMOKE_COUNTS ")]
            out.append((json.loads(line[-1][13:]) if line else None, err,
                        p.returncode))
        return out


def _rank_run(cli, argv, world, env=None, expect_ok=True, timeout=600):
    """``_Ranks(...)`` waited for at once."""
    return _Ranks(cli, argv, world, env).collect(expect_ok, timeout)


def _mpii_tree(root, n_images):
    """A learnable synthetic MPII tree and its train records' count (the
    split drawn from SEED and persisted, as phase 6 does)."""
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations
    from bilinear_tpu_torch.data.synthetic import write_mpii_dataset

    write_mpii_dataset(root, n_train_images=n_images, n_test_images=1,
                       learnable=True, seed=SEED)
    return len(MPIIAnnotations(root, Task.Train, split_seed=SEED))


def _check_rank_counts(name, counts, steps):
    """Every rank: 107 K3-train and K4 launches per step, each a staged
    call of four stage entries."""
    want = {"resmodule_fwd_train": RES_PER_FORWARD * steps,
            "resmodule_bwd": RES_PER_FORWARD * steps,
            "resmodule_fwd_stages": 4 * RES_PER_FORWARD * steps,
            "resmodule_bwd_stages": 4 * RES_PER_FORWARD * steps}
    for r, c in enumerate(counts):
        got = {k: c[k] for k in want}
        if got != want:
            raise AssertionError(f"{name} rank {r}: launches {got}, "
                                 f"expected {want}")
    return want


def _trees_equal(a, b):
    import numpy as np

    fa, fb = _flat(a), _flat(b)
    return sorted(fa) == sorted(fb) and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


def _held_to_yardstick(name, got, ref, yardstick, loss_ref, loss_gate,
                       yardstick_ref=None):
    """A multi-rank run held, as phase 7 holds bf16, to how far another
    evaluation of the same step lands: ``got`` no farther from ``ref``
    than PARITY_BF16_RATIO times ``yardstick`` is from ``yardstick_ref``
    (default ``ref``), in the median and 90th percentile of the per-tensor
    gradient gaps (``_square_avg_rels``) and in the worst BN-statistics
    leaf; its loss within ``loss_gate`` of ``loss_ref``'s. For bf16
    (``ref`` one f32 process, ``yardstick`` one bf16 process): a batch
    split rounds every layer at other points, and bf16 gradients of a
    random net sit far from f32 on any path. For End2End in f32 (``ref``
    one fused process; ``yardstick`` the standard path over the same 2
    ranks, against one standard process): its joint loss amplifies
    rounding (ROADMAP.md Queue 3 item 2), so the fused split is held to
    the spread that the same split gives on the standard path."""
    yardstick_ref = yardstick_ref or ref
    q_got = _quantiles(_square_avg_rels(got, ref)[0])
    q_yard = _quantiles(_square_avg_rels(yardstick, yardstick_ref)[0])
    stats = {k: _leaf_gap(run["payload"]["state"]["batch_stats"],
                          base["payload"]["state"]["batch_stats"])[0]
             for k, run, base in (("got", got, ref),
                                  ("yardstick", yardstick, yardstick_ref))}
    gaps = {"loss": _rel(got["loss"], loss_ref["loss"]),
            "grad_rel_median": q_got[0.5], "grad_rel_p90": q_got[0.9],
            "bn_stats_leaf": stats["got"]}
    gates = {"loss": loss_gate,
             "grad_rel_median": PARITY_BF16_RATIO * q_yard[0.5],
             "grad_rel_p90": PARITY_BF16_RATIO * q_yard[0.9],
             "bn_stats_leaf": PARITY_BF16_RATIO * stats["yardstick"]}
    log(f"  {name}: loss {got['loss']:.6f} (against {loss_ref['loss']:.6f})"
        "; " + ", ".join(f"{k} {v:.2e} (gate {gates[k]:.2e})"
                         for k, v in gaps.items())
        + f"; the yardstick: median {q_yard[0.5]:.2e}, p90 "
          f"{q_yard[0.9]:.2e}, BN {stats['yardstick']:.2e}")
    if got["files"] != yardstick["files"] or \
            any(gaps[k] > gates[k] for k in gaps):
        raise AssertionError(f"{name}: {gaps} (gates {gates})")
    return dict(gaps, gates=gates)


def _hg_args(mpii, dtype, root, epochs=None):
    return ["--data-dir", mpii, "--batch-size", str(DETECTOR_BATCH),
            "--epochs-per-run", str(epochs or P16_EPOCHS[dtype]),
            "--steps-per-dispatch", "1",
            "--comment", "hg", "--seed", str(SEED), "--dtype", dtype,
            "--fused-blocks", "true", "--save-root", root]


def _e2e_args(h36m, root, fused="true"):
    return ["--data-dir", h36m, "--variant", "torch7", "--fused-blocks",
            fused, "--batch-size", str(DETECTOR_BATCH), "--epochs-per-run",
            "1", "--comment", "e2e", "--seed", str(SEED), "--learning-rate",
            "2.5e-5", "--save-root", root]


# The fused DP legs' epochs (one step each): f32's 2-rank step is timed
# alone on epoch 2; bf16's legs run side by side, untimed, so one epoch.
P16_EPOCHS = {"float32": 2, "bfloat16": 1}


def drive_fused_dp(work, mpii, card):
    """Phase 16b, each leg alone on the card (they are timed):
    ``train_hourglass --fused-blocks true`` at full width in one process,
    f32 and bf16, and over 2 ranks sharing this card in f32 (gloo; the 7
    train records of an 8-image tree: one step of 3 + 4 rows per epoch,
    P16_EPOCHS epochs) against one process at phase 15's gates
    (``_held_to``); every rank's K3/K4 launches and stage entries, and the
    ms of epoch 2's step. The bf16 run over 2 ranks is a side-by-side leg
    (``start_background_legs``). Returns (record, the one-process runs,
    launches)."""
    from bilinear_tpu_torch.cli import train_hourglass

    steps = -(-_train_records(mpii) // DETECTOR_BATCH)
    files = [f"{e}.save" for e in range(1, P16_EPOCHS["float32"] + 1)]
    out, refs, launches = {"steps_per_epoch": steps}, {}, {}
    for dtype in ("float32", "bfloat16"):
        with _StepTimer() as timer:
            run_cli(train_hourglass.main, _hg_args(
                mpii, dtype, os.path.join(work, f"p16_one_{dtype}")))
        ref = refs[dtype] = _save_digests(os.path.join(
            work, f"p16_one_{dtype}", "hg"))
        out[dtype] = {"one_process_step_ms": timer.ms}
        if dtype == "bfloat16":
            log(f"  fused bf16 step on {card}, one process: "
                f"{timer.ms[-1]:.2f} ms (its one epoch's step, warm-up "
                f"included; the bf16 legs' reference)")
            continue
        root = os.path.join(work, f"p16_dp_{dtype}")
        counts = [c for c, _, _ in _rank_run(
            "train_hourglass", _hg_args(mpii, dtype, root), 2)]
        per_rank = _check_rank_counts(f"fused DP {dtype}", counts,
                                      steps * P16_EPOCHS[dtype])
        got = _save_digests(os.path.join(root, "hg"))
        if "backend gloo" not in got["log"]:
            raise AssertionError("the fused DP run is not on gloo")
        out[dtype].update(
            gaps=_held_to(f"fused DP 2 ranks, full width, {dtype}", got, ref,
                          adam=False, files=files),
            launches_per_rank=per_rank,
            dp_2_ranks_step_ms=[c["step_ms"] for c in counts])
        log(f"  fused {dtype} step on {card}, epoch 2: one process "
            f"{timer.ms[-1]:.2f} ms, 2 ranks sharing the card over gloo "
            f"{counts[0]['step_ms'][-1]:.2f} / {counts[1]['step_ms'][-1]:.2f}"
            f" ms; per rank {per_rank}")
        for k, v in per_rank.items():
            launches[k] = launches.get(k, 0) + 2 * v
    return out, refs, launches


def start_background_legs(work, mpii, h36m):
    """Phase 16's untimed multi-process legs, started side by side: the
    fused bf16 run over 2 ranks (full width), the planted fault (2 ranks,
    every staged call's first exchange skipped) through each gated fused
    DP leg (f32, bf16, End2End), one rank on NCCL (bf16), End2End over 2
    ranks fused and standard (f32), and the preemption legs (one process
    and 2 ranks, depth cut to P16_CUT_STACKS stacks; the signalled rank
    sends itself SIGTERM inside epoch 1 of 3)."""
    small = ["--data-dir", mpii, "--batch-size", str(DETECTOR_BATCH),
             "--comment", "hg", "--seed", str(SEED), "--dtype", "bfloat16",
             "--fused-blocks", "true", "--n-stacks", str(P16_CUT_STACKS),
             "--epochs-per-run", "3"]
    fault = {"SMOKE_SKIP_EXCHANGE": "1"}
    return {
        "fused_bf16": _Ranks("train_hourglass", _hg_args(
            mpii, "bfloat16", os.path.join(work, "p16_dp_bfloat16")), 2),
        "fault": _Ranks("train_hourglass", _hg_args(
            mpii, "float32", os.path.join(work, "p16_fault"), 1), 2,
            env=fault),
        "fault_bf16": _Ranks("train_hourglass", _hg_args(
            mpii, "bfloat16", os.path.join(work, "p16_fault_bf16")), 2,
            env=fault),
        "nccl": _Ranks("train_hourglass", _hg_args(
            mpii, "bfloat16", os.path.join(work, "p16_nccl"), 1), 1),
        "e2e": _Ranks("train_end2end", _e2e_args(
            h36m, os.path.join(work, "p16_e2e_dp")), 2),
        "e2e_standard": _Ranks("train_end2end", _e2e_args(
            h36m, os.path.join(work, "p16_e2e_dp_standard"), "false"), 2),
        "e2e_fault": _Ranks("train_end2end", _e2e_args(
            h36m, os.path.join(work, "p16_e2e_fault")), 2, env=fault),
        "preempt_one": _Ranks("train_hourglass", small + [
            "--save-root", os.path.join(work, "p16_preempt_one")], 0,
            env={"SMOKE_SIGNAL_RANK": "0"}),
        "preempt_dp": _Ranks("train_hourglass", small + [
            "--save-root", os.path.join(work, "p16_preempt_dp")], 2,
            env={"SMOKE_SIGNAL_RANK": "1"}),
    }


def _must_fail(name, gate, *args, **kw):
    """A planted fault's run: ``gate(name, *args, **kw)`` must raise."""
    try:
        gate(name, *args, **kw)
    except AssertionError:
        log(f"  {name}: failed the gate, as it must")
    else:
        raise AssertionError(f"{name}: passed the gate")


def check_background_legs(work, legs, refs, e2e_refs, mpii):
    """Waits for ``start_background_legs``'s legs and gates them: the fused
    bf16 run over 2 ranks as phase 7 holds bf16 (``_held_to_yardstick``:
    no farther from one f32 process than 1.5x one bf16 process), with
    every rank's launches and stage entries (its step ms side by side with
    the other legs: no measure of the step alone); each
    planted fault must fail its leg's gate (f32: phase 15's against one
    process; bf16 and End2End: ``_held_to_yardstick`` as below), its
    checkpoint files those of the run it stands for; the NCCL rank (no
    stage entry) within phase 15's gates and its 1.save the one process's
    bit for bit; End2End fused over 2 ranks no farther from one fused
    process than 1.5x the standard path over 2 ranks is from one standard
    process (``_held_to_yardstick``: its joint loss amplifies rounding);
    preemption: 1.save only and exit 0, a rerun (in this process) resumes
    to 2.save, and with rank 1 alone signalled both ranks stop after epoch
    1. Returns (record, launches)."""
    from bilinear_tpu_torch.cli import train_hourglass

    out, launches = {}, {}
    steps = -(-_train_records(mpii) // DETECTOR_BATCH)
    counts = [c for c, _, _ in legs["fused_bf16"].collect()]
    per_rank = _check_rank_counts("fused DP bfloat16", counts,
                                  steps * P16_EPOCHS["bfloat16"])
    got = _save_digests(os.path.join(work, "p16_dp_bfloat16", "hg"))
    if "backend gloo" not in got["log"]:
        raise AssertionError("the fused DP run is not on gloo")
    out["fused_dp_bfloat16"] = {
        "gaps": _held_to_yardstick(
            "fused DP 2 ranks, full width, bfloat16", got, refs["float32"],
            refs["bfloat16"], refs["bfloat16"], PARITY_BF16_LOSS),
        "launches_per_rank": per_rank,
        "dp_2_ranks_step_ms_side_by_side": [c["step_ms"] for c in counts]}
    for k, v in per_rank.items():
        launches[k] = launches.get(k, 0) + 2 * v
    skipped = "the first exchange of every staged K3 skipped"
    legs["fault"].collect()
    _must_fail(f"planted fault, f32 ({skipped})", _held_to,
               _save_digests(os.path.join(work, "p16_fault", "hg")),
               refs["float32"], adam=False)
    legs["fault_bf16"].collect()
    _must_fail(f"planted fault, bf16 ({skipped})", _held_to_yardstick,
               _save_digests(os.path.join(work, "p16_fault_bf16", "hg")),
               refs["float32"], refs["bfloat16"], refs["bfloat16"],
               PARITY_BF16_LOSS)
    c = legs["nccl"].collect()[0][0]
    got = _save_digests(os.path.join(work, "p16_nccl", "hg"))
    if "backend nccl" not in got["log"]:
        raise AssertionError("the one-rank run did not take NCCL")
    if any(c[k] for k in _stage_counts()):
        raise AssertionError("one rank went through the staged entries")
    same = all(_trees_equal(got["payload"][k], refs["bfloat16"]["payload"][k])
               for k in ("state", "optimizer"))
    out["nccl_1_rank_bf16"] = {
        "gaps": _held_to("fused bf16, one rank on NCCL", got,
                         refs["bfloat16"], adam=False),
        "bit_equal_to_one_process": same,
        "stage_entries": {k: c[k] for k in _stage_counts()}}
    log(f"  one rank on NCCL: its 1.save is the one process's bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError("one rank on NCCL: its 1.save is not the one "
                             "process's bit for bit")
    counts = [c for c, _, _ in legs["e2e"].collect()]
    per_rank = _check_rank_counts("fused End2End DP", counts, 1)
    for k, v in per_rank.items():
        launches[k] = launches.get(k, 0) + 2 * v
    legs["e2e_standard"].collect()
    standard = _save_digests(os.path.join(work, "p16_e2e_dp_standard",
                                          "e2e"), end2end=True)
    e2e_gate = dict(yardstick=standard, loss_ref=e2e_refs["true"],
                    loss_gate=DIST_STEP_REL, yardstick_ref=e2e_refs["false"])
    out["end2end_fused_dp_2"] = {
        "gaps": _held_to_yardstick(
            "End2End fused DP 2 ranks, f32 (yardstick: the standard path "
            "over 2 ranks against one standard process)", _save_digests(
                os.path.join(work, "p16_e2e_dp", "e2e"), end2end=True),
            e2e_refs["true"], **e2e_gate),
        "launches_per_rank": per_rank}
    legs["e2e_fault"].collect()
    _must_fail(f"planted fault, End2End ({skipped})", _held_to_yardstick,
               _save_digests(os.path.join(work, "p16_e2e_fault", "e2e"),
                             end2end=True), e2e_refs["true"], **e2e_gate)
    legs["preempt_one"].collect()
    legs["preempt_dp"].collect()
    one = os.path.join(work, "p16_preempt_one")
    files = sorted(os.listdir(os.path.join(one, "hg", "parameter")))
    run_cli(train_hourglass.main, [
        "--data-dir", mpii, "--batch-size", str(DETECTOR_BATCH), "--comment",
        "hg", "--seed", str(SEED), "--dtype", "bfloat16", "--fused-blocks",
        "true", "--n-stacks", str(P16_CUT_STACKS), "--epochs-per-run",
        "1", "--save-root", one])
    resumed = sorted(os.listdir(os.path.join(one, "hg", "parameter")))
    with open(os.path.join(one, "hg", "debug.log")) as f:
        text = f.read()
    dp_files = sorted(os.listdir(os.path.join(
        work, "p16_preempt_dp", "hg", "parameter")))
    out["preemption"] = {"one_process": files, "resumed": resumed,
                         "dp_2_rank_1_signalled": dp_files}
    log(f"  preemption: {out['preemption']}")
    if files != ["1.save"] or resumed != ["1.save", "2.save"] or \
            "Preempted after epoch 1" not in text or \
            "Resumed from epoch 1" not in text or dp_files != ["1.save"]:
        raise AssertionError(f"preemption: {out['preemption']}")
    return out, launches


def drive_remat(mpii):
    """Phase 16c: ``HourglassTrainer(remat=True)`` at full width, batch 8
    (the tree's 7 records and one zero pad), fused bf16 and standard f32
    (cuDNN's deterministic algorithms): its loss, BN buffers and gradients
    against a plain step's (bit for bit fused; standard within twice the
    gap between two plain steps), peak memory with and without remat, and
    the K3/K4 launches (the recomputation runs K3 again)."""
    import torch
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline
    from bilinear_tpu_torch.train import hourglass as th

    pipe = MPIIHostPipeline(MPIIAnnotations(mpii, Task.Train,
                                            split_seed=SEED),
                            DETECTOR_BATCH, transport="u8", pad=True)
    host = next(iter(pipe.epoch(1, prefetch=0)))
    draws = th.sample_augment(th.step_generator(SEED, 1, 1), DETECTOR_BATCH)
    out = {}
    for label, dtype, fused in (("fused_bf16", torch.bfloat16, True),
                                ("standard_f32", torch.float32, False)):
        runs = {}
        # cuDNN's deterministic algorithms, so that two plain steps' spread
        # measures this path's own run-to-run difference (zero, if none of
        # its kernels adds in a run-dependent order)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        for mode in ("plain", "plain_again", "remat"):
            trainer = th.HourglassTrainer(dtype=dtype, fused_blocks=fused,
                                          remat=mode == "remat")
            state = trainer.init_state(SEED)
            batch = trainer.batch_tensors(host)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_res_counts()
            loss = float(trainer.train_step(state, batch, draws))
            torch.cuda.synchronize()
            runs[mode] = {
                "loss": loss, "peak": torch.cuda.max_memory_allocated(),
                "counts": _res_counts(),
                "grads": {k: p.grad.float().clone() for k, p in
                          state.model.named_parameters()
                          if p.grad is not None},
                "buffers": {k: b.clone() for k, b in
                            state.model.named_buffers()}}
            del trainer, state, batch
            torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = deterministic

        def gap(a, b):
            g = max(float((a["grads"][k] - b["grads"][k]).abs().max())
                    for k in a["grads"])
            s = max(float((a["buffers"][k].double() - b["buffers"][k]
                           .double()).abs().max()) for k in a["buffers"])
            return {"loss": abs(a["loss"] - b["loss"]), "grad_max": g,
                    "buffer_max": s}

        p, p2, r = runs["plain"], runs["plain_again"], runs["remat"]
        spread, rg = gap(p2, p), gap(r, p)
        ok = all(rg[k] <= 2 * spread[k] for k in rg)
        want = {"resmodule_fwd_train": 2 * RES_PER_FORWARD if fused else 0,
                "resmodule_bwd": RES_PER_FORWARD if fused else 0,
                "resmodule_fwd_eval": 0}
        leg = {"remat_vs_plain": rg, "plain_vs_plain": spread,
               "peak_bytes_plain": p["peak"], "peak_bytes_remat": r["peak"],
               "launches_plain": p["counts"], "launches_remat": r["counts"]}
        log(f"  remat {label}: gap to a plain step {rg} (two plain steps "
            f"{spread}); peak {p['peak'] / 2**30:.3f} GiB plain, "
            f"{r['peak'] / 2**30:.3f} GiB remat; launches "
            f"{p['counts']} plain, {r['counts']} remat")
        if not ok or r["peak"] >= p["peak"] or r["counts"] != want:
            raise AssertionError(f"remat {label}: {leg}")
        out[label] = leg
        del runs, p, p2, r
        torch.cuda.empty_cache()
    return out


def drive_debug_nans(work, mpii):
    """Phase 16d: ``--debug-nans`` on a clean fused step at full width and
    P16_CUT_STACKS stacks (passes) and with an infinity planted in a fused
    block's weight (``FloatingPointError`` naming the block)."""
    import numpy as np
    from bilinear_tpu_torch.cli import train_hourglass
    from bilinear_tpu_torch.io import checkpoint as pckpt
    from bilinear_tpu_torch.utils import weights as wt

    out = {}
    root = os.path.join(work, "p16_nans")
    argv = ["--data-dir", mpii, "--batch-size", str(DETECTOR_BATCH),
            "--epochs-per-run", "1", "--comment", "hg", "--seed", str(SEED),
            "--dtype", "bfloat16", "--fused-blocks", "true",
            "--n-stacks", str(P16_CUT_STACKS), "--debug-nans", "true",
            "--save-root", root]
    t0 = time.perf_counter()
    run_cli(train_hourglass.main, argv)
    out["clean_step_s"] = time.perf_counter() - t0
    pdir = os.path.join(root, "hg", "parameter")
    payload = pckpt.load_checkpoint(pdir, 1)
    key = "hgArray.1.res2.0.resSeq.5.weight"  # the last stack's, a 3x3
    path = {k: p for k, p, _ in wt.torch7_param_paths(wt.torch7_config_of_jax(
        payload["state"]["params"]))}[key]
    leaf = np.array(wt.get_leaf(payload["state"]["params"], path))
    leaf.flat[0] = np.inf
    wt.put_leaf(payload["state"]["params"], path, leaf)
    pckpt.save_checkpoint(pdir, 1, payload["state"]["params"],
                          payload["state"]["batch_stats"],
                          payload["optimizer"], step=payload["step"])
    try:
        run_cli(train_hourglass.main, argv)
    except FloatingPointError as e:
        if "hgArray.1.res2.0" not in str(e):
            raise AssertionError(f"the error names another module: {e}")
        out["planted_inf_error"] = str(e)
        log(f"  --debug-nans: the clean step passed "
            f"({out['clean_step_s']:.1f} s); the planted inf stopped the "
            f"run: FloatingPointError: {e}")
    else:
        raise AssertionError("--debug-nans let a planted inf through")

    return out


def drive_profile(work):
    """Phase 16f: ``train_bilinear --profile true``: the trace file under
    the run and the CUDA kernels in it."""
    from bilinear_tpu_torch.cli import train_bilinear
    from bilinear_tpu_torch.data.synthetic import write_h36m_dataset

    data = os.path.join(work, "p16_prof_h36m")
    write_h36m_dataset(data, n_train=256, n_valid=16, seed=SEED)
    root = os.path.join(work, "p16_prof")
    run_cli(train_bilinear.main, ["--data-dir", data, "--save-root", root,
                                  "--comment", "bi", "--epochs-per-run",
                                  "1", "--profile", "true"])
    traces = [os.path.join(dp, f) for dp, _, fs in os.walk(
        os.path.join(root, "bi", "plugins", "profile")) for f in fs
        if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"--profile wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log(f"  --profile: {traces[0][len(root):]} holds {len(events)} events, "
        f"{len(kernels)} of them CUDA kernels")
    if not kernels:
        raise AssertionError("the trace holds no CUDA kernel")
    return {"events": len(events), "cuda_kernels": len(kernels)}


def check_canvas_cache(data_dir, work):
    """Phase 16g, on phase 6's tree: the canvas cache's batches equal the
    uncached pipeline's bit for bit over two epochs, and the second cached
    epoch decodes no JPEG; ``train_hourglass --cache-canvases true``
    writes the cache (depth cut to one stack)."""
    import numpy as np
    from bilinear_tpu_torch.cli import train_hourglass
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations
    from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline

    kw = dict(shuffle=True, seed=SEED, transport="u8")
    ann = MPIIAnnotations(data_dir, Task.Train, split_seed=SEED)
    plain = MPIIHostPipeline(ann, DETECTOR_BATCH, **kw)
    cached = MPIIHostPipeline(ann, DETECTOR_BATCH, cache_dir=os.path.join(
        work, "p16_canvas_cache"), **kw)
    decoded = []
    for epoch in (1, 2):
        before = cached.decoded
        for a, b in zip(plain.epoch(epoch), cached.epoch(epoch)):
            for k in ("images", "centers", "scales", "keypoints", "valid",
                      "heads", "index"):
                if not np.array_equal(getattr(a, k), getattr(b, k)):
                    raise AssertionError(f"cached epoch {epoch}: {k}")
        decoded.append(cached.decoded - before)
    root = os.path.join(work, "p16_cache_cli")
    run_cli(train_hourglass.main, [
        "--data-dir", data_dir, "--save-root", root, "--comment", "c",
        "--epochs-per-run", "1", "--n-stacks", "1", "--fused-blocks",
        "true", "--dtype", "bfloat16", "--cache-canvases", "true"])
    files = sorted(os.listdir(os.path.join(data_dir, "canvas_cache",
                                           "train")))
    out = {"records": len(ann), "decoded_per_epoch": decoded,
           "cli_cache_files": files}
    log(f"  canvas cache: {out}")
    if decoded != [len(ann), 0] or len(files) != 2:
        raise AssertionError(f"canvas cache: {out}")
    return out


def drive_doctor():
    """Phase 16h: ``python -m bilinear_tpu_torch.cli.doctor``: exit 0, every
    probe present and none failed; its matmul and transfer figures."""
    p = subprocess.run([sys.executable, "-m", "bilinear_tpu_torch.cli.doctor"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if p.returncode != 0:
        raise AssertionError(f"doctor exited {p.returncode}: "
                             f"{p.stdout[-2000:]} {p.stderr[-2000:]}")
    report = json.loads(p.stdout)
    probes = {"platform", "memory", "dispatch", "sync", "transfer", "matmul",
              "kernels"}
    if set(report) != probes or any("error" in v for v in report.values()):
        raise AssertionError(f"doctor: {report}")
    m, t = report["matmul"], report["transfer"]
    log(f"  doctor: bf16 matmul {m['tflops']:.1f} TFLOP/s at n = {m['n']} "
        f"({m['share_of_peak']:.3f} of 989); pinned H2D "
        f"{t['h2d_mb_s']:.0f} MB/s, D2H {t['d2h_mb_s']:.0f} MB/s; dispatch "
        f"round trip {report['dispatch']['round_trip_ms']:.4f} ms; "
        f"{report['platform'].get('nvidia_smi')}")
    return report


def _train_records(mpii):
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.mpii import MPIIAnnotations

    return len(MPIIAnnotations(mpii, Task.Train, split_seed=SEED))


def drive_phase16(card):
    """Phase 16: the staged K3/K4, fused blocks under DP (timed legs
    alone, then the untimed multi-process legs side by side while this
    process runs End2End's one-process references, remat, --debug-nans
    and --profile), doctor last, on an idle card. The canvas cache runs in
    phase 14's tree, before it is removed. Returns (record, stage kernels'
    max |d|, launches)."""
    from bilinear_tpu_torch.cli import train_end2end
    from bilinear_tpu_torch.data.synthetic import write_h36m_dataset

    work = tempfile.mkdtemp(prefix="chip_smoke_16_")
    t0 = time.perf_counter()

    def step(text):
        log(f"{text} (phase 16 at {time.perf_counter() - t0:.1f} s)")

    try:
        step(f"phase 16a: staged K3/K4 against their plain versions on "
             f"{card}")
        errs = check_staged_resmodule()
        mpii = os.path.join(work, "p16_mpii")
        _mpii_tree(mpii, P16_TRAIN_IMAGES)
        h36m = os.path.join(work, "p16_h36m")
        write_h36m_dataset(h36m, n_train=DETECTOR_BATCH, n_valid=2,
                           with_images=True, seed=SEED)
        step("phase 16b: fused blocks over 2 ranks, timed")
        dp, refs, launches = drive_fused_dp(work, mpii, card)
        rec = {"fused_dp": dp}
        step("phase 16c-e: the fault, NCCL, End2End and preemption legs "
             "side by side; End2End references, remat, --debug-nans, "
             "--profile here")
        legs = start_background_legs(work, mpii, h36m)
        try:
            e2e_refs = {}
            for fused in ("true", "false"):
                root = os.path.join(work, f"p16_e2e_one_{fused}")
                run_cli(train_end2end.main, _e2e_args(h36m, root, fused))
                e2e_refs[fused] = _save_digests(os.path.join(root, "e2e"),
                                                end2end=True)
            rec["remat"] = drive_remat(mpii)
            rec["debug_nans"] = drive_debug_nans(work, mpii)
            rec["profile"] = drive_profile(work)
            bg, bg_launches = check_background_legs(work, legs, refs,
                                                    e2e_refs, mpii)
        except BaseException:
            for ranks in legs.values():
                for p in ranks.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            raise
        dp["bfloat16"].update(bg.pop("fused_dp_bfloat16"))
        rec.update(bg)
        for k, v in bg_launches.items():
            launches[k] = launches.get(k, 0) + v
        step("phase 16f: doctor")
        rec["doctor"] = drive_doctor()
        step("phase 16: done")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rec, errs, launches


def phase16_alone() -> int:
    """Phases 1, 2 and 16 only: a quick loop on phase 16 (``python3 -c
    "import chip_smoke, sys; sys.exit(chip_smoke.phase16_alone())"``)."""
    import torch
    from bilinear_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = _build.build_all(["lifting", "lifting_int8", "resmodule",
                             "int8_conv"])
    log(f"card: {card}; built in {secs:.1f} s")
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_16g_")
    try:
        _mpii_tree(os.path.join(work, "MPII"), N_TRAIN_IMAGES)
        cache = check_canvas_cache(os.path.join(work, "MPII"), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec, errs, launches = drive_phase16(card)
    rec["canvas_cache"] = cache
    log(json.dumps({"phase16": rec, "errs": errs, "launches": launches},
                   default=str))
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return 0


# ------------------------------------------------------------ phase 17

P17_SLABS = (2, 4)  # slabs of the image's H axis, all on this card
P17_BATCHES = (1, 8)
P17_RES = 256
P17_F32_GATE = 1e-5  # f32 standard: of the heatmaps' largest value
P17_YARDSTICK = 1.5  # phase 13's: x the unsharded model's distance to f32
P17_TIME_ITERS = 3
# K3 eval at the stem block, a 64x64 block and the hourglass waist, whose
# slabs over 4 hold one row each (two or three with their halo).
P17_K3_SHAPES = ((8, 128, 128, 64, 128), (8, 64, 64, 256, 256),
                 (8, 4, 4, 256, 256))
# K6's stage entries: samples of 32 tiles a slab (the cooperative route of
# the first stage), of 2-4 tiles (a cluster) and of one.
P17_K6_SHAPES = ((8, 64, 64, 128), (8, 16, 16, 256), (1, 4, 4, 256))
# K7 on haloed slabs: (B, H, W, Ci, Co, k) of the int8 convs, the 3x3s from
# the largest level to the waist and a 1x1.
P17_K7_SHAPES = ((8, 64, 64, 128, 128, 3), (8, 16, 16, 128, 128, 3),
                 (1, 4, 4, 128, 128, 3), (8, 8, 8, 256, 128, 1),
                 (8, 128, 128, 64, 64, 3))


def _spatial_counts():
    from bilinear_tpu_torch.ops import int8
    from bilinear_tpu_torch.ops import resmodule as rm
    from bilinear_tpu_torch.parallel import spatial

    return {"resmodule_fwd_eval": rm.LAUNCHES_FWD_EVAL,
            "int8_quantize": int8.LAUNCHES_QUANTIZE,
            "int8_quantize_stages": int8.LAUNCHES_QUANTIZE_STAGES,
            "int8_conv": int8.LAUNCHES_CONV,
            "halo_exchanges": spatial.EXCHANGES,
            "halo_bytes": spatial.EXCHANGE_BYTES}


def _zero_spatial_counts():
    from bilinear_tpu_torch.ops import int8
    from bilinear_tpu_torch.ops import resmodule as rm
    from bilinear_tpu_torch.parallel import spatial

    rm.LAUNCHES_FWD_EVAL = 0
    int8.LAUNCHES_QUANTIZE = int8.LAUNCHES_QUANTIZE_STAGES = 0
    int8.LAUNCHES_CONV = 0
    spatial.EXCHANGES = spatial.EXCHANGE_BYTES = 0


def _own_amax_scales(amaxes):
    """Planted fault: every slab quantised with its own amax."""
    from bilinear_tpu_torch.ops import int8

    return [int8.slab_scale([a]) for a in amaxes]


def check_spatial_kernels():
    """Phase 17a: the kernels on slabs, through parallel/spatial.py's own
    rules, bit for bit against the kernels on the whole tensor: K3 eval on
    each haloed slab (cropped) at P17_K3_SHAPES in bf16 and f32, also held
    to the plain version at phase 3b's gates; K6's stage entries (each
    slab's amax, the maximum over the slabs, quantisation with that scale)
    against the one-launch K6 and their plain versions, int8 values and
    scales, bf16 and f32; K7 on each haloed int8 slab against the one-call
    K6 + K7 and the plain version on the whole tensor, bf16, with the
    routes plan_conv picks for the slabs. A planted fault (slabs quantised
    with their own amax) must break K7's equality. Returns (record, max
    |d| to the plain versions)."""
    import torch
    from bilinear_tpu_torch.ops import int8
    from bilinear_tpu_torch.ops import resmodule as rm
    from bilinear_tpu_torch.parallel import spatial
    from bilinear_tpu_torch.parallel.mesh import gather_spatial, \
        shard_spatial

    dev = torch.device("cuda")
    errs = {"resmodule_fwd_eval": 0.0, "int8_quantize_stages": 0.0,
            "int8_conv": 0.0}
    rec = {"k3": [], "k6": [], "k7": []}
    for i, shape in enumerate(P17_K3_SHAPES):
        x, _, p, stats = res_case(shape, SEED + 1700 + i, dev)
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            whole = rm.res_block_eval(x, p, stats, dtype=dtype)
            plain = rm.res_block_ref(x, p, train=False, stats=stats,
                                     dtype=dtype)[0]
            for s in P17_SLABS:
                parts = shard_spatial(_mesh(s), x, axis=1, unit=1)
                got = gather_spatial(spatial._res_block_eval(
                    spatial.Slabs(parts), p, stats, dtype=dtype).parts)
                torch.cuda.synchronize()
                mx, _ = gate_close(f"K3 eval over {s} haloed slabs {shape} "
                                   f"{tag} vs plain", got, plain,
                                   *RES_GATES[("K3", tag)])
                errs["resmodule_fwd_eval"] = max(errs["resmodule_fwd_eval"],
                                                 mx)
                eq = bool(torch.equal(got, whole))
                rec["k3"].append({"shape": shape, "dtype": tag, "slabs": s,
                                  "bit_equal_to_whole": eq,
                                  "slab_rows": [t.shape[1] for t in parts]})
                if not eq:
                    raise AssertionError(f"K3 on haloed slabs {shape} {tag} "
                                         f"S={s} is not K3 on the whole")
    log(f"  K3 eval on haloed slabs: {len(rec['k3'])} cases bit-equal to "
        "K3 on the whole tensor")
    gen = torch.Generator().manual_seed(SEED + 1710)
    for shape in P17_K6_SHAPES:
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            b, h, w, c = shape
            x = (torch.randn(shape, generator=gen) * (torch.rand(
                b, 1, 1, 1, generator=gen) * 3 + 0.1)).to(dtype).cuda()
            xq1, s1 = int8.quantize_activations(x)
            for s in P17_SLABS:
                parts = shard_spatial(_mesh(s), x, axis=1, unit=1)
                amax = [int8.activation_amax(t) for t in parts]
                scale = int8.slab_scale(amax)
                xq = torch.cat([int8.quantize_scaled(t, scale)
                                for t in parts], 1)
                plain_ok = all(
                    torch.equal(a, int8.activation_amax_ref(t))
                    and torch.equal(int8.quantize_scaled(t, scale),
                                    int8.quantize_scaled_ref(t, scale))
                    for a, t in zip(amax, parts))
                ok = torch.equal(xq, xq1) and torch.equal(
                    scale, s1.reshape(-1)) and plain_ok
                rec["k6"].append({"shape": shape, "dtype": tag, "slabs": s,
                                  "equal": bool(ok)})
                if not ok:
                    raise AssertionError(f"K6 stages {shape} {tag} S={s}: "
                                         "not the one-launch K6's bits")
    log(f"  K6 stage entries: {len(rec['k6'])} cases equal to the one "
        "launch and to their plain versions (int8 values, amax, scales)")
    routes = set()
    for j, (b, h, w, ci, co, k) in enumerate(P17_K7_SHAPES):
        conv = torch.nn.Conv2d(ci, co, k, padding=(k - 1) // 2)
        with torch.no_grad():
            conv.weight.mul_(1 + torch.rand(co, 1, 1, 1, generator=gen))
        conv = conv.cuda()
        x = torch.relu(torch.randn(b, ci, h, w, generator=gen)).to(
            torch.bfloat16).cuda().contiguous(
                memory_format=torch.channels_last)
        whole = int8.conv2d(conv, x, torch.bfloat16)
        plain = int8.int8_conv_ref(
            x.permute(0, 2, 3, 1), prepared=int8.prepared_kernel(conv),
            out_dtype=torch.bfloat16).permute(0, 3, 1, 2)
        if not torch.equal(whole, plain):
            raise AssertionError(f"K6 + K7 {(b, h, w, ci, co, k)} is not "
                                 "the plain version's")
        for s in P17_SLABS:
            parts = shard_spatial(_mesh(s), x, axis=2, unit=1)
            for i, t in enumerate(parts):  # each haloed slab's plan
                hh = t.shape[2] + (k - 1) // 2 * ((i > 0) + (i < s - 1))
                routes.add(int8.plan_conv(b, hh, w, ci, co, k).route)
            got = gather_spatial(spatial._int8_conv2d(
                conv, spatial.Slabs(parts), torch.bfloat16).parts, axis=2)
            eq = bool(torch.equal(got, whole))
            rec["k7"].append({"shape": (b, h, w, ci, co, k), "slabs": s,
                              "bit_equal": eq})
            if not eq:
                raise AssertionError(f"K7 on haloed slabs "
                                     f"{(b, h, w, ci, co, k)} S={s} is not "
                                     "K7 on the whole")
            if j == 0 and s == 2:
                real = spatial._slab_scales
                spatial._slab_scales = _own_amax_scales
                try:
                    bad = gather_spatial(spatial._int8_conv2d(
                        conv, spatial.Slabs(parts), torch.bfloat16).parts,
                        axis=2)
                finally:
                    spatial._slab_scales = real
                if torch.equal(bad, whole):
                    raise AssertionError("the planted own-amax fault "
                                         "passed K7's gate")
                log("  planted fault, slabs quantised with their own amax: "
                    "K7's equality fails, as it must")
    rec["k7_routes"] = sorted(routes)
    log(f"  K7 on haloed int8 slabs: {len(rec['k7'])} cases bit-equal to "
        f"the whole tensor's (and its plain version); routes {sorted(routes)}")
    torch.cuda.synchronize()
    return rec, errs


def _p17_ms(fn, iters: int = P17_TIME_ITERS) -> float:
    """ms per call of ``fn`` by CUDA events after one warm-up call."""
    import torch

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


def _p17_models(sd):
    """The full-width torch7 MainModel from ``sd`` (phase 6's 2.save, or a
    seeded one with scrambled BN statistics) as standard f32, fused bf16
    and int8 bf16, and the full-width preact StackedHourglass (seeded, BN
    statistics scrambled) as standard f32 and int8 bf16, on the card, in
    eval mode."""
    import torch
    from bilinear_tpu_torch.models.hourglass import StackedHourglass
    from bilinear_tpu_torch.models.hourglass_torch7 import MainModel

    def scrambled(model, seed):
        gen = torch.Generator().manual_seed(seed)
        out = model.state_dict()
        for k, v in out.items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=gen) * 0.1)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
        return out

    if sd is None:
        sd = scrambled(MainModel(generator=torch.Generator().manual_seed(
            SEED + 1720)), SEED + 1721)
    pre_sd = scrambled(StackedHourglass(generator=torch.Generator()
                                        .manual_seed(SEED + 1722)),
                       SEED + 1723)
    models = {}
    for label, cls, state, kw in (
            ("torch7_f32", MainModel, sd, {}),
            ("torch7_fused_bf16", MainModel, sd,
             dict(fused=True, dtype=torch.bfloat16)),
            ("torch7_int8", MainModel, sd,
             dict(quantize="int8", dtype=torch.bfloat16)),
            ("preact_f32", StackedHourglass, pre_sd, {}),
            ("preact_int8", StackedHourglass, pre_sd,
             dict(quantize="int8", dtype=torch.bfloat16))):
        m = cls(**kw)
        m.load_state_dict(state)
        models[label] = m.cuda().eval()
    return models


def _skip_first_halo(spatial, along=None):
    """Planted fault: the first halo exchange's rows (along dim ``along``,
    any by default) replaced by zeros."""
    import torch

    real = spatial._edge_rows
    calls = []

    def skipped(t, r, dim, last, dev):
        rows = real(t, r, dim, last, dev)
        if along is not None and dim != along:
            return rows
        calls.append(1)
        return torch.zeros_like(rows) if len(calls) == 1 else rows

    return real, skipped


def _p17_faults(models, refs, images):
    """The planted faults, each through a whole sharded forward over 2
    slabs that must fail its gate: the first halo exchange skipped (zero
    rows instead) in the f32 standard forward (the stem's 7x7), in the
    fused bf16 one (K3's first, rows along NHWC's H) and in the int8 one
    (the first int8 3x3's); the int8 slabs quantised with their own amax.
    Returns a record of each fault's distances."""
    from bilinear_tpu_torch.parallel import spatial

    plain = refs["torch7_f32"]
    scale = float(plain.abs().max())
    rec = {}
    for name, label, attr, along in (
            ("skipped_halo", "torch7_f32", "_edge_rows", None),
            ("skipped_halo", "torch7_fused_bf16", "_edge_rows", 1),
            ("skipped_halo", "torch7_int8", "_edge_rows", 1),
            ("own_amax", "torch7_int8", "_slab_scales", None)):
        if attr == "_edge_rows":
            real, planted = _skip_first_halo(spatial, along)
        else:
            real, planted = spatial._slab_scales, _own_amax_scales
        setattr(spatial, attr, planted)
        try:
            bad = spatial.make_spatial_fn(models[label], _mesh(2))(images)
        finally:
            setattr(spatial, attr, real)
        d_own = float((bad - refs[label]).abs().max())
        row = {"max_abs_to_unsharded": d_own}
        if label.endswith("f32"):
            passed = d_own <= P17_F32_GATE * scale
            gate = f"<= {P17_F32_GATE} x {scale:.4e}"
        else:
            d = float((bad - plain).abs().max())
            d_ref = float((refs[label] - plain).abs().max())
            in_yardstick = d <= P17_YARDSTICK * d_ref
            passed = in_yardstick and bool(bad.equal(refs[label]))
            gate = f"bit-equal and <= {P17_YARDSTICK} x {d_ref:.4e}"
            row.update(max_abs_to_plain_f32=d,
                       within_yardstick_alone=in_yardstick)
        log(f"  planted fault {name} in {label} over 2 slabs: max|d| to "
            f"unsharded {d_own:.3e}" + (
                f", to plain f32 {row['max_abs_to_plain_f32']:.4e}, "
                f"within the yardstick alone {row['within_yardstick_alone']}"
                if "max_abs_to_plain_f32" in row else "")
            + f"; gate {gate}: fails, as it must" * (not passed))
        if passed:
            raise AssertionError(f"the planted fault {name} in {label} "
                                 f"passed its gate {gate}: {row}")
        rec[f"{name}_{label}"] = row
    return rec


def drive_spatial(sd=None):
    """Phase 17b-d: the spatially sharded eval forward
    (parallel/spatial.py) of both full-width detectors on 256x256 frames
    at batch 1 and 8 over ["cuda:0"] * S, S in P17_SLABS, against the
    unsharded model (S = 1): f32 standard within P17_F32_GATE of the
    heatmaps' largest value; fused bf16 and int8 the unsharded forward's
    bits, and no farther from the unsharded plain f32 model than
    P17_YARDSTICK x the unsharded bf16 / int8 model is; launches per
    forward (K3 eval 107 S, K7 321 S or 345 S, K6's stage entries 2 x that,
    no one-launch K6, no K3 in int8), halo exchanges and bytes; the planted
    faults (``_p17_faults``) must each fail; ms per forward at S = 1, 2, 4
    (torch7, three modes) and the device time of one S = 2 fused forward by
    trace. Returns (record, launches)."""
    import torch
    from bilinear_tpu_torch.parallel import spatial

    models = _p17_models(sd)
    rec = {"forwards": {}, "times_ms": {}}
    launches = {"resmodule_fwd_eval": 0, "int8_quantize_stages": 0,
                "int8_conv": 0}
    per_k7 = {"torch7": INT8_PER_FORWARD["torch7"],
              "preact": INT8_PER_FORWARD["preact"]}
    for b in P17_BATCHES:
        images = torch.rand((b, P17_RES, P17_RES, 3),
                            generator=torch.Generator(device="cuda")
                            .manual_seed(SEED + 1730 + b), device="cuda")
        with torch.no_grad():
            refs = {k: m(images) for k, m in models.items()}
        for label, model in models.items():
            variant = label.split("_")[0]
            plain = refs[f"{variant}_f32"]
            scale = float(plain.abs().max())
            for s in P17_SLABS:
                fn = spatial.make_spatial_fn(model, _mesh(s))
                _zero_spatial_counts()
                got = fn(images)
                torch.cuda.synchronize()
                counts = _spatial_counts()
                if not torch.isfinite(got).all() or \
                        got.shape != refs[label].shape:
                    raise AssertionError(f"{label} S={s} b={b}: "
                                         f"{tuple(got.shape)}, finite "
                                         f"{bool(torch.isfinite(got).all())}")
                equal = bool(torch.equal(got, refs[label]))
                d_own = float((got - refs[label]).abs().max())
                row = {"bit_equal": equal, "max_abs_to_unsharded": d_own,
                       "launches": counts}
                if label.endswith("f32"):
                    ok = d_own <= P17_F32_GATE * scale
                    row["gate"] = f"<= {P17_F32_GATE} x {scale:.4e}"
                else:
                    d = float((got - plain).abs().max())
                    d_ref = float((refs[label] - plain).abs().max())
                    ok = equal and d <= P17_YARDSTICK * d_ref
                    row.update(max_abs_to_plain_f32=d,
                               unsharded_max_abs_to_plain_f32=d_ref,
                               gate=f"bit-equal and <= {P17_YARDSTICK} x "
                                    f"{d_ref:.4e}")
                want = {}
                if "fused" in label:
                    want = {"resmodule_fwd_eval": RES_PER_FORWARD * s,
                            "int8_conv": 0, "int8_quantize_stages": 0}
                elif "int8" in label:
                    want = {"int8_conv": per_k7[variant] * s,
                            "int8_quantize_stages": 2 * per_k7[variant] * s,
                            "resmodule_fwd_eval": 0}
                else:
                    want = {"resmodule_fwd_eval": 0, "int8_conv": 0}
                want["int8_quantize"] = 0
                counted = all(counts[k] == n for k, n in want.items())
                for k in launches:
                    launches[k] += counts[k]
                log(f"  {label} b={b} S={s}: max|d| to unsharded "
                    f"{d_own:.3e}, bit-equal {equal}, gate {row['gate']}"
                    + (f" (to plain f32 {row['max_abs_to_plain_f32']:.4e})"
                       if "max_abs_to_plain_f32" in row else "")
                    + f"; launches {counts}")
                if not ok:
                    raise AssertionError(f"{label} b={b} S={s} out of its "
                                         f"gate: {row}")
                if not counted:
                    raise AssertionError(f"{label} b={b} S={s} launches "
                                         f"{counts}, want {want}")
                rec["forwards"][f"{label}_b{b}_S{s}"] = row
        if b == P17_BATCHES[0]:
            rec["faults"] = _p17_faults(models, refs, images)
        for label in ("torch7_f32", "torch7_fused_bf16", "torch7_int8"):
            model = models[label]
            row = {}
            with torch.no_grad():
                row["S1"] = _p17_ms(lambda: model(images))
            for s in P17_SLABS:
                fn = spatial.make_spatial_fn(model, _mesh(s))
                row[f"S{s}"] = _p17_ms(lambda: fn(images))
            rec["times_ms"][f"{label}_b{b}"] = row
            log(f"  {label} b={b}: ms per forward " + ", ".join(
                f"{k} {v:.2f}" for k, v in row.items()))
    fn = spatial.make_spatial_fn(models["torch7_fused_bf16"], _mesh(2))
    per = _trace_whole(lambda: fn(images), 1)
    dev_ms = sum(ms for ms, _ in per.values())
    copy_ms = sum(ms for key, (ms, _) in per.items()
                  if "Cat" in key or "copy" in key.lower())
    rec["trace_fused_bf16_b8_S2"] = {
        "device_ms": dev_ms, "kernels": sum(c for _, c in per.values()),
        "cat_and_copy_ms": copy_ms, "top": sorted(
            ((k[:60], ms) for k, (ms, _) in per.items()),
            key=lambda kv: -kv[1])[:8]}
    log(f"  one fused bf16 forward at b=8 over 2 slabs by trace: {dev_ms:.3f}"
        f" ms of device time in {rec['trace_fused_bf16_b8_S2']['kernels']:.0f}"
        f" kernels, {copy_ms:.3f} ms of it in cat and copy kernels"
        f" (the halos' torch.cat and the crops)")
    return rec, launches


def stage_times():
    """K6's two stage entries at INT8_MAIN_SHAPE's input (bf16) by CUDA
    events, one slab (the whole tensor), beside their plain versions and
    the one-launch K6; the bound is K6's (x read once, int8 written once:
    the second read of the split is not in it)."""
    import torch
    from bilinear_tpu_torch.ops import int8

    b, h, w, ci, co, k = INT8_MAIN_SHAPE
    x = torch.randn((b, h, w, ci), generator=torch.Generator()
                    .manual_seed(SEED + 1740)).to(torch.bfloat16).cuda()

    def stages():
        int8.quantize_scaled(x, int8.slab_scale([int8.activation_amax(x)]))

    def plain():
        int8.quantize_scaled_ref(x, int8.slab_scale(
            [int8.activation_amax_ref(x)]))

    ms, plain_ms = _p17_ms(stages, 20), _p17_ms(plain, 20)
    one_ms = _p17_ms(lambda: int8.quantize_activations(x), 20)
    bound_ms, by = int8_bound("int8_quantize", b, (h, w, ci, co, k))
    per = _trace_whole(stages, 5)
    k6 = {key: v for key, v in per.items() if "quantize" in key}
    trace_ms = sum(v[0] for v in k6.values())
    log(f"  K6 stage entries at {(b, h, w, ci)} bf16: {ms:.4f} ms by events "
        f"(amax, scale, quantise: the wrappers' host time), "
        f"{trace_ms:.4f} ms of device time in "
        f"{sum(v[1] for v in k6.values()):.0f} kernels by trace "
        f"({sum(v[0] for v in per.values()):.4f} with the scale's torch "
        f"ops), plain {plain_ms:.4f}, one-launch K6 {one_ms:.4f}, bound "
        f"{bound_ms:.4f} ({by})")
    return {"ms": ms, "trace_ms": trace_ms, "plain_ms": plain_ms,
            "one_launch_ms": one_ms, "bound_ms": bound_ms, "bound_by": by,
            "shape_bhwc": [b, h, w, ci]}


def drive_phase17(card, sd=None):
    """Phase 17: spatial sharding. Returns (record, launches, max |d| of the
    kernels to their plain versions)."""
    t0 = time.perf_counter()
    log(f"phase 17a: K3, K6's stage entries and K7 on haloed slabs on {card}")
    rec = {}
    rec["kernels"], errs = check_spatial_kernels()
    log(f"phase 17b: the sharded forwards on {card} (phase 17 at "
        f"{time.perf_counter() - t0:.1f} s); the slabs share one card: "
        "these times are no scaling figure")
    rec["spatial"], launches = drive_spatial(sd)
    rec["k6_stage_times"] = stage_times()
    rec["card"] = card
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 17: done in {rec['seconds']:.1f} s")
    return rec, launches, errs


def phase17_alone() -> int:
    """Phases 1, 2 and 17 only, on a seeded full-width torch7 model (no
    2.save): ``python3 -c "import chip_smoke, sys;
    sys.exit(chip_smoke.phase17_alone())"``."""
    import torch
    from bilinear_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = _build.build_all(["resmodule", "int8_conv"])
    log(f"card: {card}; built in {secs:.1f} s")
    rec, launches, errs = drive_phase17(card)
    log(json.dumps({"phase17": rec, "launches": launches, "errs": errs},
                   default=str))
    return 0


# ------------------------------------------------------------------ main

# K6/K7 replace no Pallas kernel: the JAX functions they stand for are XLA.
INT8_SOURCES = {
    "int8_quantize": ("bilinear_tpu_torch/csrc/int8_conv.cu",
                      "bilinear_tpu/ops/int8.py:43"),
    "int8_conv": ("bilinear_tpu_torch/csrc/int8_conv.cu",
                  "bilinear_tpu/ops/int8.py:53"),
}
SOURCES = {
    "lifting_bf16": ("bilinear_tpu_torch/csrc/lifting.cu",
                     "bilinear_tpu/ops/pallas/lifting.py:46"),
    "lifting_f32": ("bilinear_tpu_torch/csrc/lifting.cu",
                    "bilinear_tpu/ops/pallas/lifting.py:46"),
    "lifting_int8_dynamic": ("bilinear_tpu_torch/csrc/lifting_int8.cu",
                             "bilinear_tpu/ops/pallas/lifting_int8.py:109"),
    "lifting_int8_static": ("bilinear_tpu_torch/csrc/lifting_int8.cu",
                            "bilinear_tpu/ops/pallas/lifting_int8.py:109"),
    "resmodule_fwd_train": ("bilinear_tpu_torch/csrc/resmodule.cu",
                            "bilinear_tpu/ops/pallas/resmodule.py:702"),
    "resmodule_fwd_eval": ("bilinear_tpu_torch/csrc/resmodule.cu",
                           "bilinear_tpu/ops/pallas/resmodule.py:702"),
    "resmodule_bwd": ("bilinear_tpu_torch/csrc/resmodule.cu",
                      "bilinear_tpu/ops/pallas/resmodule.py:756"),
}


# ------------------------------------------------------------ phase 3d

# HRNet-W48's and ViTPose-H's epilogues (K8) at their served batch of 128:
# name -> (channels, (height, width), terms, ReLU). A term is ("bn", m), a
# raw conv output at 1/2^m of the size with its BN table, or ("x", m), an
# activation; "head" is the 1x1 head's output with scale 1 and its bias,
# written in f32. ViTPose's sides (24, 48) are the first that are no
# powers of two for K8's multiply-shift index division.
K8_BATCH = 128
K8_SHAPES = {
    "basic_block_48x64": (48, (64, 64), [("bn", 0), ("x", 0)], True),
    "exchange_row0_stage4": (48, (64, 64), [("x", 0), ("bn", 1), ("bn", 2),
                                            ("bn", 3)], True),
    "basic_block_96x32": (96, (32, 32), [("bn", 0), ("x", 0)], True),
    "basic_block_192x16": (192, (16, 16), [("bn", 0), ("x", 0)], True),
    "basic_block_384x8": (384, (8, 8), [("bn", 0), ("x", 0)], True),
    "exchange_row3_stage4": (384, (8, 8), [("bn", 0), ("bn", 0), ("bn", 0),
                                           ("x", 0)], True),
    "stem_64x128": (64, (128, 128), [("bn", 0)], True),
    "bottleneck_downsample_256x64": (256, (64, 64), [("bn", 0), ("bn", 0)],
                                     True),
    "head_16x64": (16, (64, 64), [("head", 0)], False),
    "vit_deconv_256x32x24": (256, (32, 24), [("bn", 0)], True),
    "vit_deconv_256x64x48": (256, (64, 48), [("bn", 0)], True),
    "head_16x64x48": (16, (64, 48), [("head", 0)], False),
}
K8_TIME_SHAPES = ("basic_block_48x64", "exchange_row0_stage4")
K8_SOURCE = ("bilinear_tpu_torch/csrc/conv_epilogue.cu",
             "none: port kernel, no Pallas counterpart (the JAX package has "
             "no HRNet)")


def k8_case(name: str, dtype, seed: int):
    """(terms, relu, out dtype, bytes the call must move) of one shape of
    ``K8_SHAPES`` on the card, seeded: activations N(0, 1) in ``dtype``,
    BN tables with scales U(0.2, 2) and shifts N(0, 0.5)."""
    import torch

    c, (h, w), kinds, relu = K8_SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    terms, nbytes = [], 0
    for kind, m in kinds:
        x = torch.randn(K8_BATCH, c, h >> m, w >> m, device="cuda",
                        generator=gen)
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        table = None
        if kind == "bn":
            table = torch.stack([
                torch.rand(c, device="cuda", generator=gen) * 1.8 + 0.2,
                torch.randn(c, device="cuda", generator=gen) * 0.5])
        elif kind == "head":
            table = torch.stack([
                torch.ones(c, device="cuda"),
                (torch.randn(c, device="cuda", generator=gen) * 0.5).to(
                    dtype).float()])
        terms.append((x, table))
        nbytes += x.numel() * x.element_size()
    out_dtype = torch.float32 if kinds[0][0] == "head" else None
    out_size = (4 if out_dtype is not None else
                torch.empty((), dtype=dtype).element_size())
    nbytes += K8_BATCH * c * h * w * out_size
    return terms, relu, out_dtype, nbytes


def _k8_gate(name: str, terms, got, want, dtype) -> float:
    """K8 against its plain version on the same tensors: f32 within 1e-6
    of the largest; bf16 equal but for at most 1e-3 of the elements, each
    off by at most one bf16 unit of the largest magnitude along the
    element's way (a term's x * scale, the term after its BN, either sum)
    per rounding of a term: the kernel's BN is one fused multiply-add, the
    plain version's a multiply rounded to f32 and an add, so a term may
    round the other way (most often where the shift cancels the product),
    and each later rounded add may move the two sums one unit further apart
    (two ties rounded to even in opposite directions). The head (scale 1)
    bit for bit. Returns the largest absolute difference."""
    import torch
    from bilinear_tpu_torch.ops.conv_epilogue import conv_epilogue_ref

    d = (got.float() - want.float()).abs()
    err = float(d.max())
    if name.startswith("head") and not torch.equal(got, want):
        raise AssertionError(f"K8 {name}: the head is not its plain "
                             f"version bit for bit (max {err})")
    if dtype == torch.float32:
        if err > 1e-6 * float(want.abs().max()):
            raise AssertionError(f"K8 {name} f32: max abs err {err}")
        return err
    share = float((d > 0).float().mean())
    mags = torch.maximum(want.float().abs(), got.float().abs())
    zero = torch.zeros_like(terms[0][0])
    for x, table in terms:
        parts = [table] if table is None else [table, torch.stack(
            [table[0], torch.zeros_like(table[1])])]
        for t in parts:
            mags = torch.maximum(mags, conv_epilogue_ref(
                [(zero.float(), None), (x.float(), t)]).abs())
    _, e = torch.frexp(mags)
    ulp = torch.ldexp(torch.ones_like(d), e - 8) * len(terms)
    if share > 1e-3 or bool((d > ulp).any()):
        bad = (d > ulp).nonzero()[:3].tolist()
        raise AssertionError(
            f"K8 {name} bf16: {share:.2e} of the elements differ, max {err}, "
            f"beyond one bf16 unit: {int((d > ulp).sum())}, e.g. at "
            f"{bad}: kernel, plain, largest magnitude " + str(
                [(float(got[tuple(i)]), float(want[tuple(i)]),
                  float(mags[tuple(i)])) for i in bad]))
    return err


def check_k8() -> tuple:
    """K8 at every shape of ``K8_SHAPES`` in bf16 and f32 against its plain
    version, one launch a call; a planted fault (a term read at the wrong
    resolution step) must be caught. Returns (max abs err,
    {"phase3d_checks": launches})."""
    import torch
    from bilinear_tpu_torch.ops import conv_epilogue as ce

    err, launches = 0.0, 0
    for i, name in enumerate(K8_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            terms, relu, out_dtype, _ = k8_case(name, dtype, SEED + i)
            before = ce.LAUNCHES
            got = ce.conv_epilogue(terms, relu, out_dtype)
            torch.cuda.synchronize()
            if ce.LAUNCHES != before + 1:
                raise AssertionError(f"K8 {name}: {ce.LAUNCHES - before} "
                                     f"launches for one call")
            launches += 1
            want = ce.conv_epilogue_ref(terms, relu, out_dtype)
            err = max(err, _k8_gate(name, terms, got, want, dtype))
            log(f"  K8 {name} {str(dtype)[6:]}: max abs err vs plain "
                f"{float((got.float() - want.float()).abs().max()):.3g}")
    terms, relu, out_dtype, _ = k8_case("exchange_row0_stage4",
                                        torch.bfloat16, SEED)
    x, table = terms[1]
    wrong = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
    planted = ce.conv_epilogue([terms[0], (wrong[:, :, :32, :32]
                                           .contiguous(memory_format=
                                                       torch.channels_last),
                                           table)] + terms[2:], relu)
    launches += 1
    want = ce.conv_epilogue_ref(terms, relu)
    try:
        _k8_gate("planted fault", terms, planted, want, torch.bfloat16)
    except AssertionError:
        log("  K8: the planted fault (a term read at the wrong step) is "
            "caught")
    else:
        raise AssertionError("K8: the planted fault passed the gate")
    return err, {"phase3d_checks": launches}


# K8 launches in one served chunk of each detector that runs it.
K8_SERVED = {"hrnet": 262, "vitpose": 3}


def k8_served_chunk(variant: str) -> int:
    """One 128-frame chunk of a full-size ``variant`` (seeded init) through
    End2EndServer, on frames of its own input size: K8 launches a chunk
    (``K8_SERVED``) and finite answers. The counter is zeroed just before
    the call."""
    import numpy as np
    import torch
    from bilinear_tpu_torch.models.detectors import detector
    from bilinear_tpu_torch.models.end2end import End2End
    from bilinear_tpu_torch.ops import conv_epilogue as ce
    from bilinear_tpu_torch.serving import End2EndServer
    from bilinear_tpu_torch.utils import weights as wt

    model = End2End(variant=variant,
                    generator=torch.Generator().manual_seed(SEED))
    params, stats = wt.end2end_to_jax(model.state_dict(), variant)
    del model
    server = End2EndServer(
        {"params": params, "batch_stats": stats}, np.zeros(32), np.ones(32),
        np.zeros(48), np.ones(48), variant=variant, dtype=torch.bfloat16,
        batch_sizes=(K8_BATCH,), device="cuda")
    frames = np.random.default_rng(SEED).integers(
        0, 256, (K8_BATCH, *detector(variant).input_size, 3), np.uint8)
    ce.LAUNCHES = 0
    pose2d, pose3d = server.predict(frames)
    n = ce.LAUNCHES
    if n != K8_SERVED[variant] or not (np.isfinite(pose2d).all() and
                                       np.isfinite(pose3d).all()):
        raise AssertionError(f"K8: {n} launches in a served {variant} chunk "
                             f"({K8_SERVED[variant]} expected), finite "
                             f"answers: {np.isfinite(pose2d).all()}")
    log(f"  K8: {n} launches in one served 128-frame {variant} chunk of "
        f"{frames.shape[1]} x {frames.shape[2]} frames")
    del server
    torch.cuda.empty_cache()
    return n


def time_k8() -> dict:
    """K8 at ``K8_TIME_SHAPES`` in bf16: ms a call by CUDA events and by a
    profiler trace (one device kernel a call), the bound (its bytes at HBM
    bandwidth), the plain version's ms by events, the wrapper's host us a
    call."""
    import torch
    from bilinear_tpu_torch.ops import conv_epilogue as ce

    rows = {}
    for name in K8_TIME_SHAPES:
        terms, relu, out_dtype, nbytes = k8_case(name, torch.bfloat16, SEED)

        def kernel():
            ce.conv_epilogue(terms, relu, out_dtype)

        def plain():
            ce.conv_epilogue_ref(terms, relu, out_dtype)

        ms = cuda_ms(kernel, 200)
        per = _trace(kernel, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            kernel()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        c, (h, w) = K8_SHAPES[name][:2]
        rows[name] = {
            "shape_bchw": [K8_BATCH, c, h, w],
            "terms": len(terms), "ms": ms, "plain_ms": cuda_ms(plain, 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes,
            "trace_ms": sum(t for t, _ in per.values()),
            "device_kernels_per_call": sum(c for _, c in per.values()),
            "host_us_per_call": host_us}
        if rows[name]["device_kernels_per_call"] != 1:
            raise AssertionError(f"K8 {name}: not one device kernel a call: "
                                 f"{per}")
        log(f"  K8 {name}: {ms:.4f} ms by events, "
            f"{rows[name]['trace_ms']:.4f} by trace, bound "
            f"{rows[name]['bound_ms']:.4f} ({nbytes} bytes), plain "
            f"{rows[name]['plain_ms']:.4f}, host {host_us:.1f} us a call")
    return rows


def drive_k8() -> tuple:
    """Phase 3d: K8's checks, a served chunk's launches, its times.
    Returns (max abs err, launches by path, time rows)."""
    err, launches = check_k8()
    launches.update({f"phase3d_served_{v}_chunk": k8_served_chunk(v)
                     for v in K8_SERVED})
    return err, launches, time_k8()


def k8_entry(err: float, launches: dict, rows: dict) -> dict:
    """K8's record in the kernels line."""
    main = rows[K8_TIME_SHAPES[0]]
    return {
        "name": "conv_epilogue", "route": "cuda", "source": K8_SOURCE[0],
        "replaces": K8_SOURCE[1], "launches": sum(launches.values()),
        "launches_by_path": launches, "max_abs_err": err,
        "shape_bchw": main["shape_bchw"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "trace_ms": main["trace_ms"],
        "device_kernels_per_call": main["device_kernels_per_call"],
        "host_us_per_call": main["host_us_per_call"],
        "at_" + K8_TIME_SHAPES[1]: rows[K8_TIME_SHAPES[1]]}


def phase3d_alone() -> int:
    """Phases 1, 2 (K8's source alone) and 3d: ``python3 -c "import
    chip_smoke, sys; sys.exit(chip_smoke.phase3d_alone())"``."""
    import torch
    from bilinear_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = _build.build_all(["conv_epilogue"])
    log(f"card: {card}; built in {secs:.1f} s")
    err, launches, rows = drive_k8()
    log(json.dumps({"kernels": [k8_entry(err, launches, rows)]}))
    return 0


PROBE_SOURCES = {  # K5's modes: (the probe's row, the Pallas body)
    "int8_scale_probe_fixed": ("fixed", "benchmarks/int8_scale_probe.py:65"),
    "int8_scale_probe_mxu": ("mxu-bound", "benchmarks/int8_scale_probe.py:85"),
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
    secs = _build.build_all(["lifting", "lifting_int8", "resmodule",
                             "int8_conv", "int8_scale_probe",
                             "conv_epilogue"])
    log(f"phase 2: built csrc/lifting.cu, csrc/lifting_int8.cu, "
        f"csrc/resmodule.cu, csrc/int8_conv.cu, csrc/int8_scale_probe.cu "
        f"and csrc/conv_epilogue.cu in {secs:.1f} s")

    # phase 3: kernels vs plain versions
    log("phase 3: kernels vs plain versions")
    params, stats = bilinear_to_jax(random_state_dict(SEED))
    errs, scales = check_kernels(params, stats)
    log("phase 3b: K3 (train, eval) and K4 vs their plain versions")
    errs.update(check_resmodule())
    log("phase 3c: K5, the int8 scale probe's chains, vs their plain "
        "versions; the probe's rows")
    probe_errs, probe_rows, probe_launches = drive_probe(params, stats, card)
    for name, e in probe_errs.items():
        errs[name] = max(errs.get(name, 0.0), e)
    log("phase 3d: K8, the conv epilogue, vs its plain version; a served "
        "HRNet chunk and a served ViTPose chunk; its times")
    k8 = drive_k8()

    # phase 4: the slice
    log("phase 4: serving over HTTP")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, _ = drive_slice(work)

        # phase 5: times
        log(f"phase 5: times on {card}")
        table = time_kernels(params, stats, scales)
        trace_lifting(params, stats, scales, table)
        check_bulk_route(params, stats)
        table["lifting_bf16"]["routes"] = time_bulk_routes(params, stats)
        time_path_boundary(params, stats, scales)
        time_weight_checks(params, stats)
        end_to_end = time_end_to_end(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    keep = tempfile.mkdtemp(prefix="chip_smoke_keep_")
    try:
        result = _run_after_phase5(card, keep, errs, launches, table,
                                   end_to_end, (probe_rows, probe_launches))
        result["kernels"].append(k8_entry(*k8))
        return result
    finally:
        shutil.rmtree(keep, ignore_errors=True)


def _run_after_phase5(card, keep, errs, launches, table, end_to_end, probe):
    """Phases 9, 6-8 and 10-14, and the kernels' record; ``keep`` holds
    phase 9's lifting checkpoint for phase 12; ``probe``: phase 3c's rows
    and K5's launches."""
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # phase 9: training lifting
        log("phase 9: training the full-width lifting MLP through "
            "cli.train_bilinear, validating and serving it")
        lift_launches, lift_mpjpe, lift_served, lift_losses = \
            drive_lifting_training(work)
        lift_parameter_dir = os.path.join(keep, "lift_parameter")
        shutil.copytree(os.path.join(work, "save", "lift", "parameter"),
                        lift_parameter_dir)
        log(f"phase 9: lifting training times on {card}")
        lift_times = time_lifting_training()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # phase 6: the detector slice
        log("phase 6: training the full-width detector through "
            "cli.train_hourglass --fused-blocks true")
        res_launches, data_dir, losses = drive_detector(work)
        launches.update(res_launches)
        # phase 7: step parity
        log("phase 7: full-width step parity, fused vs standard")
        parity = step_parity(data_dir)
        # phase 8: times
        log(f"phase 8: detector times on {card}")
        res_table = time_resmodule()
        steps = time_train_step(data_dir)
        # phase 10: detector evaluation
        log("phase 10: evaluating the full-width detector through "
            "cli.valid_hourglass and cli.eval_hourglass")
        eval_launches = drive_detector_eval(data_dir, work)
        eval_parity = detector_eval_parity(data_dir, work)
        log(f"phase 10: detector evaluation times on {card}")
        eval_times = time_detector_eval(data_dir, work)
        # phase 11: fine-tuning, the SH conversions, lifting from SH+FT
        log("phase 11: fine-tuning the full-width preact detector on H36M "
            "through cli.train_hourglass_ft, evaluating it, converting "
            "GT->SH+FT and GT->SH, lifting from SH+FT")
        ft_result, sh_launches = drive_ft(work)
        h36m_dir = os.path.join(work, "Human3.6M")
        log("phase 11: the full-width preact model, f32 against float64")
        ft_result["parity_vs_float64"] = ft_parity(h36m_dir)
        log(f"phase 11: fine-tuning and SH conversion times on {card}")
        ft_result["times"] = time_ft(h36m_dir, work)
        # phase 12: End2End
        log("phase 12: training End2End (torch7, fused) through "
            "cli.train_end2end, evaluating it, the webcam demo, serving "
            "/v1/pose")
        e2e_train_launches, e2e_losses = drive_e2e_training(
            work, lift_parameter_dir)
        e2e_eval_launches, e2e_eval = drive_e2e_eval(work)
        e2e_serve_launches, e2e_k1, e2e_serving = drive_e2e_serving(work)
        log("phase 12: End2End step parity, fused vs standard, f32")
        e2e_result = {"losses": e2e_losses, "evaluation": e2e_eval,
                      "serving": e2e_serving,
                      "step_parity_f32": e2e_parity(work)}
        log(f"phase 12: End2End times on {card}")
        e2e_result["times"] = time_e2e(work)
        # phase 13: the detectors' int8 convolutions
        log("phase 13: the detectors' int8 convolutions: K6/K7 vs their "
            "plain versions, serve --kind both --quantize int8")
        int8_shapes, int8_result = int8_conv_shapes()
        int8_result = {"launches_per_forward": int8_result}
        int8_errs, int8_result["routes_checked"] = check_int8_kernels(
            int8_shapes)
        errs.update(int8_errs)
        int8_launches, int8_result["serving"] = drive_int8_serving(work)
        log(f"phase 13: int8 times on {card}")
        int8_times = time_int8(int8_shapes)
        int8_result["serving_times"] = time_int8_serving(work)
        # phase 14: AOT export
        log("phase 14: AOT export through cli.export_aot, fresh-process "
            "loads, serve --aot")
        aot_result = drive_aot(work)
        # phase 16g runs here, while phase 6's tree exists
        log("phase 16g: the canvas cache on phase 6's tree")
        cache_result = check_canvas_cache(data_dir, work)
        # phase 17: spatial sharding, on phase 6's 2.save
        log("phase 17: spatial sharding of both detectors' eval forward "
            "(halo exchanges, K3 on haloed slabs, K6's stage entries)")
        import torch
        p17, p17_launches, p17_errs = drive_phase17(card, _detector_model(
            os.path.join(work, "save", "smoke"), torch.float32, False,
            "cuda").state_dict())
        for name, e in p17_errs.items():
            errs[name] = max(errs.get(name, 0.0), e)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # phase 15: camera and bins, DP/TP training, mesh serving, PP
    log("phase 15: camera and bin generation, DP/TP training, mesh-sharded "
        "serving, pipeline parallelism")
    p15, p15_launches = drive_phase15(card)
    # phase 16: fused blocks under DP, remat, --debug-nans, preemption,
    # --profile, doctor
    log("phase 16: fused blocks over 2 ranks (staged K3/K4), remat, "
        "--debug-nans, preemption, --profile, doctor")
    p16, staged_errs, p16_launches = drive_phase16(card)
    p16["canvas_cache"] = cache_result
    for name, e in staged_errs.items():
        errs[name] = max(errs[name], e)

    by_path = {name: {"phase4_serving": launches[name]}
               for name in SOURCES if not name.startswith("resmodule")}
    for name, n in lift_launches.items():
        by_path[name]["phase9_serving_the_trained_model"] = n
    by_path["lifting_bf16"]["phase12_lift_beside_pose"] = e2e_k1
    for name in SOURCES:
        if name.startswith("resmodule"):
            by_path[name] = {"phase6_training": launches[name],
                             "phase10_evaluation": eval_launches[name],
                             "phase11_sh_export": sh_launches[name],
                             "phase12_end2end_training":
                                 e2e_train_launches[name],
                             "phase12_end2end_evaluation":
                                 e2e_eval_launches[name],
                             "phase12_end2end_serving":
                                 e2e_serve_launches[name]}
    for name, paths in p15_launches.items():
        if name in by_path:
            by_path[name].update(paths)
    for name in ("resmodule_fwd_train", "resmodule_bwd"):
        by_path[name]["phase16_fused_dp_ranks"] = p16_launches[name]
    by_path["resmodule_fwd_eval"]["phase17_spatial"] = p17_launches[
        "resmodule_fwd_eval"]
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        if name.startswith("resmodule"):
            at = res_table[name]
            main, big = at[RES_TIME_SHAPES[0]], at[RES_TIME_SHAPES[1]]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path[name].values()),
                "launches_by_path": by_path[name],
                "max_abs_err": errs[name],
                "shape_bhwio": list(RES_TIME_SHAPES[0]),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": None,
                "yardstick_standard_module_ms":
                    main["yardstick_standard_module_ms"],
                "trace_ms": main["trace_ms"],
                "device_kernels_per_call": main["device_kernels_per_call"],
                "at_" + "x".join(map(str, RES_TIME_SHAPES[1])): big,
                "per_shape": [dict(row, shape_bhwio=list(shape))
                              for shape, row in at.items()],
            })
            if name != "resmodule_fwd_eval":
                kind = "fwd" if name == "resmodule_fwd_train" else "bwd"
                kernels[-1]["staged_entries_phase16"] = p16_launches[
                    f"resmodule_{kind}_stages"]
            continue
        at = table[name]
        main, big = at[TIME_NS[0]], at[TIME_NS[1]]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": errs[name], "n": TIME_NS[0],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "yardstick_cublas_chain_ms": main["cublas_chain_ms"],
            "trace_ms": main["trace_ms"],
            "device_kernels_per_call": main["device_kernels_per_call"],
            f"at_{TIME_NS[1]}": big,
            "bulk_routes": at.get("routes"),
        })
    log(json.dumps({"lifting_end_to_end": end_to_end}))
    log(json.dumps({"detector": {"losses": losses, "step_parity": parity,
                                 "train_step": steps}}))
    log(json.dumps({"lifting_training": {
        "losses": lift_losses, "cli_mpjpe": lift_mpjpe,
        "served_mpjpe": lift_served, "train_step": lift_times}}))
    log(json.dumps({"detector_evaluation": {
        "recalibrated_stats_max_rel_diff": eval_parity,
        "times": eval_times}}))
    log(json.dumps({"fine_tuning_and_sh": ft_result}))
    for name, (source, replaces) in INT8_SOURCES.items():
        main = int8_times["main"]
        k = "k6" if name == "int8_quantize" else "k7"
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": int8_launches[name] + sum(
                p15_launches.get(name, {}).values())
            + p17_launches.get(name, 0),
            "launches_by_path": dict({"phase13_int8_serving":
                                      int8_launches[name],
                                      "phase17_spatial":
                                      p17_launches.get(name, 0)},
                                     **p15_launches.get(name, {})),
            "max_abs_err": errs[name], "shape_bhwcok": list(INT8_MAIN_SHAPE),
            "ms": main[f"{k}_ms"], "plain_ms": main[f"{k}_plain_ms"],
            "bound_ms": main[f"{k}_bound_ms"],
            "bound_by": main.get(f"{k}_bound_by", "bytes"),
            "library_ms": None}
        entry["trace_ms"] = main[f"{k}_trace_ms"]
        entry["device_kernels_per_call"] = main[
            f"{k}_device_kernels_per_call"]
        entry["kernel_route"] = (main["k7_route"] if k == "k7" else {
            "route": main["k6_route"],
            "launches_per_call": main["k6_device_kernels_per_call"]})
        entry["one_call_k6_k7_ms"] = main["one_call_ms"]
        if k == "k7":
            entry["yardstick_cudnn_bf16_conv_ms"] = main["cudnn_bf16_conv_ms"]
            entry["yardstick_cudnn_bf16_conv_trace_ms"] = main[
                "cudnn_bf16_conv_trace_ms"]
            entry["yardstick_int_mm_im2col_ms"] = main["int_mm_im2col_ms"]
            entry["routes_checked"] = int8_result["routes_checked"]
            entry["per_shape"] = int8_times["per_shape"]
        kernels.append(entry)
    st = p17["k6_stage_times"]
    kernels.append({
        "name": "int8_quantize_stages", "route": "cuda",
        "source": INT8_SOURCES["int8_quantize"][0],
        "replaces": INT8_SOURCES["int8_quantize"][1],
        "launches": p17_launches["int8_quantize_stages"],
        "launches_by_path": {"phase17_spatial":
                             p17_launches["int8_quantize_stages"]},
        "max_abs_err": errs["int8_quantize_stages"],
        "shape_bhwc": st["shape_bhwc"], "ms": st["ms"],
        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"], "library_ms": None,
        "trace_ms": st["trace_ms"], "one_launch_k6_ms": st["one_launch_ms"],
        "entries": ["int8_activation_amax", "int8_quantize_scaled"]})
    probe_rows, probe_launches = probe
    for name, (variant, replaces) in PROBE_SOURCES.items():
        at = {r["n"]: r for r in probe_rows if r["variant"] == variant}
        main, big = at[TIME_NS[0]], at[TIME_NS[1]]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "k2_static_ms",
                "poses_per_sec", "trace_ms", "device_kernels_per_call")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bilinear_tpu_torch/csrc/int8_scale_probe.cu",
            "replaces": replaces, "launches": probe_launches[name],
            "launches_by_path": {"phase3c_probe_rows": probe_launches[name]},
            "max_abs_err": errs[name], "n": TIME_NS[0], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "yardstick_k2_static_ms": main["k2_static_ms"],
            "trace_ms": main["trace_ms"],
            "device_kernels_per_call": main["device_kernels_per_call"],
            f"at_{TIME_NS[1]}": {k: big[k] for k in keys}})
    log(json.dumps({"int8_scale_probe": probe_rows}))
    log(json.dumps({"end2end": e2e_result}))
    log(json.dumps({"int8": int8_result}))
    log(json.dumps({"aot": aot_result}))
    log(json.dumps({"phase15": p15}))
    log(json.dumps({"phase16": p16}, default=str))
    log(json.dumps({"phase17": p17}, default=str))
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
