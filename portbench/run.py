"""Run one cell of ``BENCHMARK.json`` once and print its result line:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Exits with 3 and prints no result without the
cards the cell needs, and with 4 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def cache_dirs(root: str) -> None:
    """Every kernel cache inside the checkout, at fixed paths. The port's
    own nvcc libraries live in ``bilinear_tpu_torch/csrc/build/``; these
    are for torch's JIT extensions and Triton, should the program come to
    use them. A library that would load JAX of its own accord is told not
    to."""
    build = os.path.join(root, "portbench", ".build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_start = time.monotonic()
    args = parse(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache_dirs(root)
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import harness

    return harness.main(args, t_start)


if __name__ == "__main__":
    sys.exit(main())
