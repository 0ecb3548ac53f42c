"""The plain reference against the port's CPU path at a small width, in
f32: the seeded ``.save`` tree loads into the port's servers, and both
sides give the same answers to rounding."""
from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from portbench import seeds
from portbench.reference import model as ref
from portbench.reference.weights import end2end_weights, lifter_pool, \
    lifter_weights
from portbench.tests.conftest import ROOT, SEED

CPU = torch.device("cpu")


def config(name: str, **sizes) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) \
            as f:
        cfg = json.load(f)
    cfg.update(sizes)
    return cfg


def host(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def small_e2e():
    cfg = config("e2e-hg8x256", nStack=2, nFeats=32, depth=2)
    w, st = end2end_weights(cfg, SEED, CPU)
    return cfg, w, st


def test_end2end_matches_the_port(small_e2e):
    from bilinear_tpu_torch.serving import End2EndServer

    cfg, w, st = small_e2e
    frames = seeds.frame_pool(SEED, 3, "test")
    with torch.no_grad():
        r2, r3 = ref.end2end(w.net, cfg, st, torch.as_tensor(frames))
    server = End2EndServer(
        w.tree(), host(st.mean_part), host(st.std_part), host(st.mean_s),
        host(st.std_s), dtype=torch.float32, batch_sizes=(1, 2),
        model_kw={"fused": True, "n_stacks": 2, "features": 32,
                  "depth": 2}, device="cpu")
    p2, p3 = server.predict(frames)
    assert np.abs(p2 - host(r2)).max() < 1e-2      # frame pixels
    assert np.abs(p3 - host(r3)).max() < 0.5       # mm, of ~300 spread
    # The soft-argmax moves with the input: the poses differ by frame.
    assert host(r2).std(axis=0).mean() > 2.0


def test_lifter_matches_the_port():
    from bilinear_tpu_torch.serving import LiftingServer

    cfg = config("lift-1024x2", linear_size=64)
    pool = lifter_pool(SEED, 512, CPU)
    w, st = lifter_weights(cfg, SEED, CPU, pool)
    tree = w.tree()
    server = LiftingServer(tree["params"], tree["batch_stats"],
                           host(st.mean_part), host(st.std_part),
                           host(st.mean_s), host(st.std_s),
                           dtype=torch.float32, device="cpu")
    kp = pool[:300].view(-1, 16, 2)
    with torch.no_grad():
        r = ref.lift(w.net, st, kp)
    got = server.lift(kp)
    assert (got - r).abs().max() < 1e-2
    assert r.std(dim=0).mean() > 10.0


def test_tree_is_the_reference_weights(small_e2e):
    """The program's copy holds the reference's values, leaf by leaf."""
    _, w, _ = small_e2e
    tree = w.tree()
    for path, leaf in w.leaves.items():
        node_p, node_s = tree["params"], tree["batch_stats"]
        for key in path:
            node_p = node_p[key]
            node_s = node_s.get(key, {}) if isinstance(node_s, dict) else {}
        for name, t in leaf.items():
            node = node_p if name in ("kernel", "bias", "scale") else node_s
            if name == "bias" and "scale" in leaf:
                node = node_p
            np.testing.assert_array_equal(node[name], host(t))


def test_seed_gives_the_same_weights():
    cfg = config("lift-1024x2", linear_size=32)
    pool = lifter_pool(SEED, 256, CPU)
    a, _ = lifter_weights(cfg, SEED, CPU, pool)
    b, _ = lifter_weights(copy.deepcopy(cfg), SEED, CPU, pool)
    c, _ = lifter_weights(cfg, SEED + 1, CPU, pool)
    ka = a.leaves[("encode", "linear")]["kernel"]
    assert torch.equal(ka, b.leaves[("encode", "linear")]["kernel"])
    assert not torch.equal(ka, c.leaves[("encode", "linear")]["kernel"])
