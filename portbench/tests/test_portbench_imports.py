"""Whole-name import checks: nothing ``python -m portbench.run`` imports
is JAX or the JAX package (``bilinear_tpu_torch`` begins with
``bilinear_tpu`` and is not it), and the reference imports nothing of the
program."""
from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import ROOT

PKG = os.path.join(ROOT, "portbench")


def imported_names(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def top(name: str) -> str:
    return name.split(".")[0]


def test_the_whole_name_check():
    assert top("bilinear_tpu_torch.serving") not in harness.FORBIDDEN
    assert top("bilinear_tpu.serving") in harness.FORBIDDEN
    assert top("jaxlib.xla_client") in harness.FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        for name in imported_names(path):
            assert top(name) not in harness.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(PKG, "reference", "*.py")):
        for name in imported_names(path):
            assert top(name) not in ("bilinear_tpu_torch",) \
                + harness.FORBIDDEN, (path, name)


def test_what_a_run_loads():
    """Everything a run imports, in a fresh interpreter: the harness, every
    traffic module and metric reader, and the program's servers."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    modules = sorted({w["traffic"] for w in bench["workloads"]})
    code = "; ".join(
        ["import sys, json", "import portbench.run",
         "from portbench import harness, trace, tools",
         "import portbench.tools.readings"]
        + [f"import portbench.traffic.{m}" for m in modules]
        + [f"harness.reader({m['name']!r})" for m in bench["per_layer"]]
        + ["import bilinear_tpu_torch.serving, "
           "bilinear_tpu_torch.serving_http",
           "print(json.dumps(sorted({m.split('.')[0] "
           "for m in sys.modules})))"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bilinear_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(
        harness.FORBIDDEN)
