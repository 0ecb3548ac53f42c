"""Export a trained checkpoint to a self-contained AOT serving artifact
(counterpart of ``bilinear_tpu/cli/export_aot.py``).

Captures the serving program (``torch.export``), its weights and the
normalisation statistics into ONE file that a deployment box runs with
torch alone (``io/aot.py``'s loader half; ``cli.serve --aot`` serves it).

Usage (on a machine with an NVIDIA GPU):
  # 2D->3D lifting, one symbolic-batch program:
  python -m bilinear_tpu_torch.cli.export_aot --kind lifting \\
      --run-dir "save/Bilinear GT" --data-dir data/Human3.6M \\
      --out lifting.aot

  # frame->3D at the serving batch sizes:
  python -m bilinear_tpu_torch.cli.export_aot --kind end2end \\
      --run-dir save/End2End --data-dir data/Human3.6M \\
      --out end2end.aot --batch-sizes 1 8 16

The program runs on the device it was exported for: ``--device`` (the card
by default; ``cpu`` for tests) takes the place of JAX's ``--platforms``.
"""
from __future__ import annotations

import argparse
import logging
import os

import torch

from bilinear_tpu_torch.data.h36m import Protocol, Task, load_h36m
from bilinear_tpu_torch.device import disable_tf32
from bilinear_tpu_torch.io.aot import (export_end2end, export_lifting,
                                       save_artifact)
from bilinear_tpu_torch.io.checkpoint import latest_epoch, load_checkpoint

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kind", choices=["lifting", "end2end"], required=True)
    p.add_argument("--run-dir", required=True,
                   help="run dir holding parameter/{epoch}.save")
    p.add_argument("--data-dir", required=True,
                   help="H36M dir (normalization stats from its train split)")
    p.add_argument("--out", required=True, help="artifact path to write")
    p.add_argument("--protocol", default=Protocol.GT)
    p.add_argument("--variant", default="torch7")
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--device", default=None,
                   help="the device the program is exported for and runs on "
                        "(in place of JAX's --platforms); default the GPU, "
                        "'cpu' for tests")
    p.add_argument("--quantize", default="", choices=["", "int8-static"],
                   help="lifting only: export the calibrated static-scale "
                        "int8 program")
    p.add_argument("--batch-sizes", type=int, nargs="+", default=None,
                   help="fixed batch sizes; lifting default is one "
                        "symbolic-batch program, end2end default 1 8 16")
    p.add_argument("--n-stacks", type=int, default=0,
                   help="override hourglass size (0 = production 8/256/4)")
    p.add_argument("--features", type=int, default=256)
    p.add_argument("--depth", type=int, default=4)
    return p


def main(argv=None) -> None:
    disable_tf32()
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="[%(levelname)s|export_aot] %(message)s")
    log = logging.getLogger("export_aot")
    if args.quantize and args.kind != "lifting":
        raise SystemExit("--quantize applies to --kind lifting only")
    train = load_h36m(args.data_dir, args.protocol)[Task.Train]
    dtype = DTYPES[args.dtype]
    parameter_dir = os.path.join(args.run_dir, "parameter")
    epoch = latest_epoch(parameter_dir)
    if epoch <= 0:
        raise FileNotFoundError(
            f"no checkpoint under {parameter_dir!r} — refusing to export "
            "uninitialized weights")
    state = load_checkpoint(parameter_dir, epoch)["state"]
    stats = (train.mean_part, train.std_part, train.mean_s, train.std_s)

    if args.kind == "lifting":
        programs = export_lifting(
            state["params"], state["batch_stats"], *stats, dtype=dtype,
            device=args.device, batch_sizes=args.batch_sizes,
            quantize=args.quantize or None,
            calib_sample=train.part)  # z-scored train inputs (int8-static)
    else:
        model_kw = None
        if args.n_stacks:
            model_kw = dict(n_stacks=args.n_stacks, features=args.features,
                            depth=args.depth)
        programs = export_end2end(
            state, *stats, variant=args.variant, dtype=dtype,
            model_kw=model_kw, batch_sizes=args.batch_sizes or (1, 8, 16),
            device=args.device)

    # The int8-static program fixes its own types (int8 hidden layers,
    # bf16 encode/decode); recording --dtype would mislabel it.
    dtype_recorded = "int8/bfloat16" if args.quantize else args.dtype
    if args.quantize and args.dtype == "float32":
        log.warning("--dtype float32 has no effect with --quantize %s "
                    "(encode/decode are bf16, hidden layers int8)",
                    args.quantize)
    manifest = save_artifact(
        args.out, args.kind, programs,
        manifest_extra={"epoch": epoch, "dtype": dtype_recorded,
                        "quantize": args.quantize or None,
                        "run_dir": os.path.abspath(args.run_dir)})
    log.info("wrote %s (%.1f MB): kind=%s epoch=%d device=%s programs=%s",
             args.out, os.path.getsize(args.out) / 1e6, manifest["kind"],
             epoch, manifest["device"], ",".join(manifest["programs"]))


if __name__ == "__main__":
    main()
