#!/usr/bin/env python3
"""Time the port's int8 convolution kernels (K6, K7) of ANY checkout on one
GPU, with THIS checkout's chip_smoke.time_int8: at every int8 conv shape of
a served forward at batch 8 and the main 3x3 at batches 1 and 16, K7, K6
and the whole int8 conv by CUDA events, K6 and K7 by a profiler trace
(device ms and device kernels per call), beside the bound, cuDNN's bf16
conv and torch._int_mm over an int8 im2col:

    python3 scripts/torch_int8_conv_times.py [ROOT [LABEL [OUT_DIR]]]

ROOT (default: this checkout) is the root of a checkout that holds
bilinear_tpu_torch/, for instance a `git archive` of an earlier commit
unpacked beside this one: its kernels are built from its own sources and
called through the functions every version of ops/int8.py has
(prepare_kernel, quantize_activations, int8_conv_cuda, int8_conv). Running
both in one command on one card, in turns, is how the kernels before and
after a change are compared. Then one int8 forward of the full-width
torch7 detector at 1, 8 and 16 frames, traced: K6's and K7's device time
and launches per forward. The rows go to OUT_DIR/int8_times_LABEL.json
(LABEL: default the directory's name; OUT_DIR: default the current
directory). Imports nothing of JAX.
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    label = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    spec = importlib.util.spec_from_file_location(
        "this_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)  # bilinear_tpu_torch of the checkout timed
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    from bilinear_tpu_torch.ops import _build
    from bilinear_tpu_torch.ops import int8

    if not os.path.abspath(int8.__file__).startswith(root + os.sep):
        print(f"FAIL: imported {int8.__file__}, not {root}'s ops/int8.py")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    secs = _build.build_all(["int8_conv"])
    print(f"int8 conv kernels of {root} ({label}) on {card}; built in "
          f"{secs:.1f} s", flush=True)
    result = cs.time_int8(cs.INT8_SHAPES, q=int8)
    from bilinear_tpu_torch.models.hourglass_torch7 import MainModel

    result["forward"] = cs.int8_forward_totals(MainModel)
    out_dir = sys.argv[3] if len(sys.argv) > 3 else "."
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"int8_times_{label}.json")
    with open(out, "w") as f:
        json.dump({"root": root, "card": card, **result}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
