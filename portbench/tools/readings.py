"""The numbers the comparison reads, over many seeds in one process:

    python3 -m portbench.tools.readings --workload <cell> --seconds <s> \\
        [--control] SEED [SEED ...]

prints one JSON line per seed: the check's numbers and the window's
end-to-end metrics. ``--control`` serves the program's lower-precision
path (the int8 detector or lifter) in the sound one's place. The limits in
a workload file are set from these readings; the benchmark's own runs
never take the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--assumed", default=None,
                   help="JSON of the configuration's 'assumed' entries to "
                        "replace, to try other weight statistics")
    p.add_argument("seeds", type=int, nargs="+")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        sizes = None
        if args.assumed:
            _, _, cfg = harness.cell(harness.manifest(), args.workload)
            cfg["assumed"].update(json.loads(args.assumed))
            sizes = {"config": {"assumed": cfg["assumed"]}}
        run, traffic = harness.setup_run(args.workload, seed, args.seconds,
                                         False, control=args.control,
                                         sizes=sizes)
        harness.measure(run, traffic)
        traffic.release(run)
        gc.collect()
        torch.cuda.empty_cache()
        numbers = traffic.check(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "numbers": numbers,
                          "e2e": run.e2e, "attempted": run.attempted,
                          "failed": run.failed}), flush=True)
        del run, traffic
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
