"""The port stands alone: every module of bilinear_tpu_torch, and
chip_smoke.py, imports with jax, flax, optax and bilinear_tpu refused."""
import os
import pkgutil
import subprocess
import sys

import pytest

import bilinear_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib
import importlib.abc
import sys

REFUSED = ("jax", "flax", "optax", "bilinear_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
"""


def _port_modules():
    names = [bilinear_tpu_torch.__name__]
    for info in pkgutil.walk_packages(bilinear_tpu_torch.__path__,
                                      prefix="bilinear_tpu_torch."):
        names.append(info.name)
    return names


def test_port_modules_are_listed():
    names = _port_modules()
    for expected in ("bilinear_tpu_torch.serving",
                     "bilinear_tpu_torch.serving_http",
                     "bilinear_tpu_torch.ops.lifting",
                     "bilinear_tpu_torch.ops.lifting_int8",
                     "bilinear_tpu_torch.cli.serve",
                     "bilinear_tpu_torch.ops.resmodule",
                     "bilinear_tpu_torch.models.hourglass_torch7",
                     "bilinear_tpu_torch.train.hourglass",
                     "bilinear_tpu_torch.cli.train_hourglass",
                     "bilinear_tpu_torch.train.bilinear",
                     "bilinear_tpu_torch.eval.pckh",
                     "bilinear_tpu_torch.eval.recalibrate",
                     "bilinear_tpu_torch.eval.mpii_test_export",
                     "bilinear_tpu_torch.ops.decode",
                     "bilinear_tpu_torch.cli.train_bilinear",
                     "bilinear_tpu_torch.cli.valid_bilinear",
                     "bilinear_tpu_torch.cli.valid_hourglass",
                     "bilinear_tpu_torch.cli.eval_hourglass",
                     "bilinear_tpu_torch.models.hourglass",
                     "bilinear_tpu_torch.data.h36m_images",
                     "bilinear_tpu_torch.data.sh_convert",
                     "bilinear_tpu_torch.cli.train_hourglass_ft",
                     "bilinear_tpu_torch.cli.valid_hourglass_ft",
                     "bilinear_tpu_torch.cli.sh_preprocess",
                     "bilinear_tpu_torch.models.end2end",
                     "bilinear_tpu_torch.models.hrnet",
                     "bilinear_tpu_torch.models.vitpose",
                     "bilinear_tpu_torch.train.end2end",
                     "bilinear_tpu_torch.cli.train_end2end",
                     "bilinear_tpu_torch.cli.valid_end2end",
                     "bilinear_tpu_torch.cli.webcam",
                     "bilinear_tpu_torch.ops.int8",
                     "bilinear_tpu_torch.io.aot",
                     "bilinear_tpu_torch.cli.export_aot",
                     "bilinear_tpu_torch.cli.export_torch",
                     "bilinear_tpu_torch.data.camera",
                     "bilinear_tpu_torch.data.h36m_generate",
                     "bilinear_tpu_torch.parallel.mesh",
                     "bilinear_tpu_torch.parallel.tp",
                     "bilinear_tpu_torch.parallel.pp",
                     "bilinear_tpu_torch.native",
                     "bilinear_tpu_torch.core.remat",
                     "bilinear_tpu_torch.utils.debug",
                     "bilinear_tpu_torch.utils.preempt",
                     "bilinear_tpu_torch.utils.profiling",
                     "bilinear_tpu_torch.cli.doctor",
                     "bilinear_tpu_torch.ops.int8_scale_probe"):
        assert expected in names


def test_aot_loader_imports_no_other_port_module():
    """io/aot.py, whose loader half a deployment box runs, imports torch,
    numpy and the standard library: no other module of the port (the
    export half imports the models inside its functions)."""
    code = ("import sys, bilinear_tpu_torch.io.aot; print(sorted(m for m in "
            "sys.modules if m.startswith('bilinear_tpu_torch')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split() == ["['bilinear_tpu_torch',",
                                   "'bilinear_tpu_torch.io',",
                                   "'bilinear_tpu_torch.io.aot']"]


def _torch_scripts():
    """The port's timing scripts, ``scripts/torch_*.py``, as module names."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "scripts"))
                  if f.startswith("torch_") and f.endswith(".py"))


@pytest.mark.parametrize("extra", [[], ["chip_smoke"], "scripts"],
                         ids=["package", "chip_smoke", "scripts"])
def test_imports_without_jax_or_reference_package(extra):
    if extra == "scripts":
        extra = _torch_scripts()
        assert "torch_int8_scale_probe" in extra
    names = _port_modules() + extra
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.path.join(ROOT, "scripts"),
                    os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, *names], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"imported {len(names)}" in proc.stdout


def test_models_import_no_layer_above_them():
    """The model layer sits under the trainers, the servers, the CLIs and
    the parallel wrappers: importing every module of ``models/`` loads
    none of ``train``, ``serving``, ``cli`` or ``parallel``."""
    models = [n for n in _port_modules()
              if n.startswith("bilinear_tpu_torch.models.")]
    assert "bilinear_tpu_torch.models.detectors" in models
    above = ("train", "serving", "cli", "parallel")
    code = ("import importlib, sys\n"
            f"for n in {models!r}: importlib.import_module(n)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == "
            f"'bilinear_tpu_torch' and m.split('.')[1:2] in "
            f"{[[a] for a in above]!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split() == ["[]"]
