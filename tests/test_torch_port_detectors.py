"""``models/detectors.py``: every site that depends on what a detector
supports reads the class's attributes. For each variant, ``make_model``
with fused blocks and with int8 convolutions, both trainers,
``make_spatial_fn`` and ``cli/serve.py``'s choice of fused blocks accept or
refuse as the class says; and a patch of the torch7 module's ``bn_in``
(chip_smoke.py's ``core_bn`` leg) reaches every BN of ``MainModel``."""
import types

import pytest
import torch

from bilinear_tpu_torch.cli import serve as pserve
from bilinear_tpu_torch.core.norm import BatchNorm2d
from bilinear_tpu_torch.data.h36m import Task
from bilinear_tpu_torch.models import hourglass_torch7 as ht
from bilinear_tpu_torch.models.detectors import DETECTORS, make_model
from bilinear_tpu_torch.parallel.spatial import make_spatial_fn
from bilinear_tpu_torch.train.end2end import End2EndTrainer
from bilinear_tpu_torch.train.hourglass import HourglassTrainer
from torch_port_fixtures import one_torch_thread  # noqa: F401

# (fused_blocks, int8_convs, trainable, spatial_sharding) of each variant.
SUPPORT = {"torch7": (True, True, True, True),
           "preact": (False, True, True, True),
           "hrnet": (False, False, False, False),
           "vitpose": (False, False, False, False)}
SIZES = {"torch7": dict(n_stacks=1, features=16, depth=1),
         "preact": dict(n_stacks=1, features=16, depth=1),
         "hrnet": dict(features=8),
         "vitpose": dict(depth=1)}


def _serve_fused(variant, monkeypatch) -> bool:
    """The ``fused`` that ``serve --kind end2end`` builds End2End with."""
    got = {}

    def from_run_dir(run_dir, train, variant, model_kw, **kw):
        got.update(model_kw)
        return types.SimpleNamespace(epoch=0, device="cpu")

    monkeypatch.setattr(pserve, "load_h36m",
                        lambda *a: {Task.Train: None})
    monkeypatch.setattr(pserve, "End2EndServer",
                        types.SimpleNamespace(from_run_dir=from_run_dir))
    monkeypatch.setattr(pserve, "PoseHTTPServer", lambda **kw: kw)
    pserve.build_server(pserve.build_parser().parse_args(
        ["--kind", "end2end", "--run-dir", "run", "--data-dir", "data",
         "--variant", variant]))
    return got["fused"]


SITES = {
    "make_model-fused": (0, lambda v, s: make_model(v, fused=True, **s)),
    "make_model-int8": (1, lambda v, s: make_model(v, quantize="int8", **s)),
    "hourglass-trainer": (2, lambda v, s: HourglassTrainer(
        variant=v, device="cpu", **s).init_state(0)),
    "end2end-trainer": (2, lambda v, s: End2EndTrainer(
        variant=v, device="cpu", model_kw=s).init_state(0)),
    "spatial": (3, lambda v, s: make_spatial_fn(
        make_model(v, **s).eval(), ["cpu", "cpu"])),
}


@pytest.mark.parametrize("site", list(SITES) + ["serve-fused"])
@pytest.mark.parametrize("variant", list(DETECTORS))
def test_each_site_follows_the_class(variant, site, monkeypatch):
    cls = DETECTORS[variant]
    assert cls.variant == variant
    assert (cls.fused_blocks, cls.int8_convs, cls.trainable,
            cls.spatial_sharding) == SUPPORT[variant]
    if site == "serve-fused":
        assert _serve_fused(variant, monkeypatch) is cls.fused_blocks
        return
    fact, call = SITES[site]
    if SUPPORT[variant][fact]:
        call(variant, SIZES[variant])
    else:
        with pytest.raises(ValueError, match=variant):
            call(variant, SIZES[variant])


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError, match="unknown hourglass variant"):
        make_model("resnet")


def test_a_patched_bn_in_reaches_every_bn_of_the_torch7_model(monkeypatch):
    """Each model module imports ``core/precision.py``'s helpers into its
    own namespace, so patching ``hourglass_torch7.bn_in`` changes what
    ``MainModel`` runs: one train-mode forward calls it once for each BN."""
    calls = []
    real = ht.bn_in

    def counted(bn, x, dtype):
        calls.append(bn)
        return real(bn, x, dtype)

    monkeypatch.setattr(ht, "bn_in", counted)
    model = ht.MainModel(**SIZES["torch7"]).train()
    model(torch.zeros(2, 32, 32, 3))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert len(calls) == len(bns)
    assert {id(b) for b in calls} == {id(b) for b in bns}
