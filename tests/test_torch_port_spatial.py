"""The port's spatial sharding (bilinear_tpu_torch/parallel/spatial.py and
the placement helpers of parallel/mesh.py) on the CPU, over ``["cpu"] *
S`` meshes, against the port's unsharded models and against the JAX
package's forward on ``mesh_lib.shard_spatial`` input over its 8 virtual
CPU devices (tests/test_parallel_pp.py's SP test, at its model's size:
4 stacks, 32 features, depth 2, 64-pixel images, batch 2).

Tolerances: the sharded forward is a re-partition of the same math, and on
the CPU every slab's rows are the whole image's bits (the convs on haloed
slabs, the plain K3 and the int8 conv with the whole sample's scale), so
standard, fused and int8 forwards equal their unsharded models bit for
bit. JAX's GSPMD forward is held at 1e-4 of the heatmaps' largest value
(the port's eval-parity gate, tests/test_torch_port_pp.py). JAX's int8
model on spatially sharded input stops in XLA's SPMD partitioner (an s8
broadcast fails the HLO verifier), so the port's sharded int8 forward is
held to JAX's unsharded int8 model at tests/test_torch_port_int8_conv.py's
gates (against the quantization's own error), at that file's model size
(2 stacks, 16 features), where the gates were measured. At 4 stacks and 32
features the preact's largest gap is 0.58x the quantization's largest
error, above the 0.5x gate: one activation on a rounding edge of the
quantization, which an f32 ulp of the float ops before it decides
(``test_int8_gap_to_jax_at_the_sp_size_is_a_rounding_edge`` holds it to
what an ulp of input does to the port's own int8 model). Weights cross the two
converters: the port's state_dict goes to JAX through the JAX package's
``utils/torch_compat.py``, the scrambled BN statistics come back through
the port's ``utils/weights.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.models.hourglass import StackedHourglass as JaxPreact
from bilinear_tpu.models.hourglass_torch7 import MainModel as JaxTorch7
from bilinear_tpu.parallel import mesh as mesh_lib
from bilinear_tpu.utils import torch_compat as tc
from bilinear_tpu_torch.models.hourglass import StackedHourglass
from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
from bilinear_tpu_torch.ops import int8
from bilinear_tpu_torch.parallel import mesh, spatial
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread, scramble_bn  # noqa: F401

N_STACKS, FEATURES, DEPTH, RES, BATCH = 4, 32, 2, 64, 2
UNIT = 2 ** (2 + DEPTH)
SIZE = dict(n_stacks=N_STACKS, features=FEATURES, depth=DEPTH)
INT8_SIZE = dict(n_stacks=2, features=16, depth=DEPTH)
# S = 2 and 4 split the four units evenly; three slabs take 1, 1, 2.
MESHES = {"S2": ["cpu"] * 2, "S4": ["cpu"] * 4, "uneven3": ["cpu"] * 3}

VARIANTS = {
    "torch7": (MainModel, wt.hourglass_torch7_to_jax,
               wt.hourglass_torch7_from_jax,
               lambda sd, size: tc.hourglass_torch7_from_torch(
                   sd, n_stacks=size["n_stacks"], n_depth=size["depth"]),
               lambda q, size: JaxTorch7(quantize=q, **size)),
    "preact": (StackedHourglass, wt.hourglass_preact_to_jax,
               wt.hourglass_preact_from_jax,
               lambda sd, size: tc.hourglass_from_torch(
                   sd, n_stacks=size["n_stacks"],
                   compression_time=size["depth"]),
               lambda q, size: JaxPreact(
                   stacks=size["n_stacks"], out_channels=size["features"],
                   compression_time=size["depth"], quantize=q)),
}


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(BATCH, RES, RES, 3) \
        .astype(np.float32)


def _state(size):
    """Per variant: the port's seeded state_dict with scrambled BN (through
    the port's converters) and JAX's variables of it (through JAX's)."""
    out = {}
    for name, (cls, to_jax, from_jax, jax_of_torch, _) in VARIANTS.items():
        params, stats = to_jax(cls(
            **size, generator=torch.Generator().manual_seed(0)).state_dict())
        scramble = scramble_bn(np.random.RandomState(1))
        sd = from_jax(jax.tree_util.tree_map_with_path(scramble, params),
                      jax.tree_util.tree_map_with_path(scramble, stats))
        jp, js = jax_of_torch({k: v.numpy() for k, v in sd.items()}, size)
        out[name] = (sd, {"params": jp, "batch_stats": js}, size)
    return out


@pytest.fixture(scope="module")
def state():
    return _state(SIZE)


def _model(state, name, **kw):
    sd, _, size = state[name]
    m = VARIANTS[name][0](**size, **kw)
    m.load_state_dict(sd)
    return m.eval()


def _unsharded(model, images):
    with torch.no_grad():
        return model(torch.from_numpy(images))


@pytest.fixture(scope="module")
def reference(state, images):
    """The unsharded model's heatmaps, once per variant and knobs."""
    memo = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = _unsharded(_model(state, name, **kw), images)
        return memo[key]

    return get


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("devices,blocks", [
    (1, [(0, 64)]), (2, [(0, 32), (32, 64)]),
    (3, [(0, 16), (16, 32), (32, 64)]),
    (4, [(0, 16), (16, 32), (32, 48), (48, 64)])])
def test_plan_blocks_and_round_trip(images, devices, blocks):
    plan = mesh.spatial_sharding(["cpu"] * devices, unit=UNIT)
    assert plan.axis == 1 and plan.ndim == 4
    assert plan.blocks(RES) == blocks
    slabs = mesh.shard_spatial(["cpu"] * devices, images, unit=UNIT)
    assert [s.shape[1] for s in slabs] == [hi - lo for lo, hi in blocks]
    np.testing.assert_array_equal(mesh.gather_spatial(slabs).numpy(),
                                  images)
    # The published depth's factor, 64: 256 rows in four.
    assert mesh.spatial_sharding(["cpu"] * 4, unit=64).blocks(256) == [
        (0, 64), (64, 128), (128, 192), (192, 256)]


def test_plan_errors(state, images):
    with pytest.raises(ValueError, match="multiple of the model's "
                                         "downsampling factor 16"):
        mesh.shard_spatial(["cpu"] * 2, np.zeros((1, 72, 64, 3)), unit=16)
    with pytest.raises(ValueError, match="fewer than the 5 slabs"):
        mesh.shard_spatial(["cpu"] * 5, images, unit=UNIT)
    with pytest.raises(ValueError, match="axis 4 of a 4-d"):
        mesh.spatial_sharding(["cpu"], axis=4, unit=UNIT)
    model = _model(state, "torch7")
    assert spatial.downsampling_factor(model) == UNIT
    with pytest.raises(ValueError, match="downsampling factor 16"):
        spatial.spatial_forward(model, torch.zeros(1, 40, 64, 3),
                                ["cpu"] * 2)
    with pytest.raises(ValueError, match="all cards or all the CPU"):
        spatial.spatial_forward(model, images, ["cpu", "meta"])
    with pytest.raises(ValueError, match="eval forward only"):
        spatial.spatial_forward(model.train(), images, ["cpu"] * 2)


# --------------------------------------------------------------- forwards


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_standard_equals_unsharded(state, images, reference, name,
                                   mesh_name):
    model = _model(state, name)
    want = reference(name)
    before = spatial.EXCHANGES
    got = spatial.spatial_forward(model, images, MESHES[mesh_name])
    assert got.shape == (N_STACKS, BATCH, RES // 4, RES // 4, 16)
    assert torch.equal(got, want)
    if name == "torch7":
        # The stem's 7x7 and one 3x3 per ResModule (3 + 4 x 7).
        assert spatial.EXCHANGES - before == 1 + 31


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_standard_matches_jax_sharded(state, images, name):
    """JAX's forward with the H axis sharded over its 8 virtual devices
    (GSPMD's halos) against the port's over 4 slabs."""
    jmesh = mesh_lib.make_mesh()
    xs = mesh_lib.shard_spatial(jmesh, images, axis=1)
    want = np.asarray(jax.jit(lambda v, x: VARIANTS[name][4](
        None, SIZE).apply(v, x, train=False))(state[name][1], xs))
    got = spatial.spatial_forward(_model(state, name), images,
                                  MESHES["S4"]).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_equals_unsharded_fused(state, images, reference, dtype,
                                      mesh_name):
    """K3 (its plain version here) on every haloed slab, cropped."""
    model = _model(state, "torch7", fused=True, dtype=dtype)
    want = reference("torch7", fused=True, dtype=dtype)
    got = spatial.spatial_forward(model, images, MESHES[mesh_name])
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_int8_equals_unsharded(state, images, reference, name):
    model = _model(state, name, quantize="int8")
    want = reference(name, quantize="int8")
    stages = int8.LAUNCHES_QUANTIZE_STAGES
    for devices in MESHES.values():
        got = spatial.spatial_forward(model, images, devices)
        assert torch.equal(got, want), len(devices)
    assert int8.LAUNCHES_QUANTIZE_STAGES == stages  # plain versions here


@pytest.fixture(scope="module")
def int8_state():
    return _state(INT8_SIZE)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_int8_matches_jax(int8_state, images, name):
    state = int8_state
    ref = np.asarray(jax.jit(lambda v, x: VARIANTS[name][4](
        "int8", INT8_SIZE).apply(v, x, train=False))(
            state[name][1], jnp.asarray(images)))
    got = spatial.spatial_forward(_model(state, name, quantize="int8"),
                                  images, MESHES["S4"]).numpy()
    flt = _unsharded(_model(state, name), images).numpy()
    gap, err = np.abs(got - ref), np.abs(ref - flt)
    assert gap.mean() <= 0.25 * err.mean(), (name, gap.mean() / err.mean())
    assert gap.max() <= 0.5 * err.max(), (name, gap.max() / err.max())


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_int8_gap_to_jax_at_the_sp_size_is_a_rounding_edge(state, images,
                                                            reference, name):
    """At this file's size (4 stacks, 32 features) the port's int8 model
    and JAX's differ where an activation lies on a rounding edge of the
    quantization: an f32 ulp of the float ops before it (the port's and
    XLA's need not round alike) puts it on either side. The port's own int8
    model, given the input moved by about one ulp, moves as far. The gap is
    held to that move and to test_int8_matches_jax's mean gate; the ratios
    are printed (``-s``): the preact's largest gap is 0.58x the
    quantization's largest error, above that test's 0.5x gate at its own
    size."""
    ref = np.asarray(jax.jit(lambda v, x: VARIANTS[name][4](
        "int8", SIZE).apply(v, x, train=False))(
            state[name][1], jnp.asarray(images)))
    model = _model(state, name, quantize="int8")
    got = spatial.spatial_forward(model, images, MESHES["S4"])
    assert torch.equal(got, reference(name, quantize="int8"))
    got = got.numpy()
    rs = np.random.RandomState(5)
    move = max(np.abs(_unsharded(model, (images * (1 + 2e-7 * rs.randn(
        *images.shape))).astype(np.float32)).numpy() - got).max()
        for _ in range(2))
    gap = np.abs(got - ref)
    err = np.abs(ref - reference(name).numpy())
    print(f"{name} int8 at {N_STACKS} stacks x {FEATURES} features: gap / "
          f"quantization error: mean {gap.mean() / err.mean():.4f}, max "
          f"{gap.max() / err.max():.4f}; an ulp of input moves the port "
          f"{move / err.max():.4f} of the largest error (largest gap "
          f"{gap.max():.4e}, largest move {move:.4e})")
    assert gap.mean() <= 0.25 * err.mean()
    assert gap.max() <= 1.01 * move


def test_k6_stage_plain_versions_put_back_are_one_launch(images):
    """K6's two stages on uneven slabs, the maximum taken over them, equal
    ``quantize_activations_ref`` of the whole tensor bit for bit."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy((rs.randn(3, 10, 6, 64) * rs.uniform(
        0.1, 4.0, (3, 1, 1, 1))).astype(np.float32))
    x[1] = 0.0  # a sample of zeros takes the 1e-12 floor
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        want_q, want_s = int8.quantize_activations_ref(xd)
        slabs = [xd[:, :3], xd[:, 3:4], xd[:, 4:]]
        scale = int8.slab_scale([int8.activation_amax(t) for t in slabs])
        assert scale.shape == (3,)
        np.testing.assert_array_equal(scale.numpy(),
                                      want_s.reshape(-1).numpy())
        got = torch.cat([int8.quantize_scaled(t, scale) for t in slabs], 1)
        assert torch.equal(got, want_q)
        # The conv with the given scale, on the whole tensor, is the
        # one-launch conv's bits.
        prepared = int8.prepare_kernel(
            torch.from_numpy(rs.randn(3, 3, 64, 16).astype(np.float32)))
        assert torch.equal(
            int8.int8_conv(xd, prepared=prepared, scale=scale),
            int8.int8_conv(xd, prepared=prepared))


# ----------------------------------------------------------- planted faults


@pytest.mark.parametrize("knobs,along", [
    ({}, None), (dict(fused=True, dtype=torch.bfloat16), 1),
    (dict(quantize="int8"), 1)], ids=["f32", "fused_bf16", "int8"])
def test_skipped_halo_exchange_fails(state, images, reference, knobs, along,
                                     monkeypatch):
    """One halo exchange's rows replaced by zeros: in f32 the first (the
    stem's), fused and int8 the first of K3's or the int8 3x3's rule (NHWC,
    rows along dim 1). The sharded forward is no longer the unsharded one's
    bits, and in f32 leaves JAX's gate."""
    model = _model(state, "torch7", **knobs)
    want = reference("torch7", **knobs)
    real = spatial._edge_rows
    calls = []

    def skipped(t, r, dim, last, dev):
        rows = real(t, r, dim, last, dev)
        if along is not None and dim != along:
            return rows
        calls.append(dim)
        return torch.zeros_like(rows) if len(calls) == 1 else rows

    monkeypatch.setattr(spatial, "_edge_rows", skipped)
    got = spatial.spatial_forward(model, images, MESHES["S2"])
    assert calls
    assert not torch.equal(got, want)
    if not knobs:
        assert (got - want).abs().max() > 1e-4 * want.abs().max()


def test_slabs_quantised_with_their_own_amax_fail(state, images, reference,
                                                  monkeypatch):
    model = _model(state, "torch7", quantize="int8")
    want = reference("torch7", quantize="int8")
    monkeypatch.setattr(spatial, "_slab_scales", lambda amaxes: [
        int8.slab_scale([a]) for a in amaxes])
    got = spatial.spatial_forward(model, images, MESHES["S2"])
    assert not torch.equal(got, want)


def test_weights_copied_once_per_device(state, images):
    """``Weights`` over a mesh of the CPU and the meta device (shapes
    alone): the storages of the parameters and buffers are copied once to
    the meta device, a view of one (``res_params``) is rebuilt on the copy,
    a prepared int8 kernel is copied once, and a weight changed in place is
    copied again. A mesh of one repeated device copies nothing."""
    model = _model(state, "torch7", quantize="int8")
    meta = torch.device("meta")
    before = spatial.COPIED_BYTES
    w = spatial.Weights(model, ["cpu", "meta", "cpu", "meta"])
    assert w.devices == [meta]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in w.tensors}
    assert spatial.COPIED_BYTES - before == sum(storages.values())
    block = model.hgArray[0].res1[0]
    p = block.res_params()
    for t in (p.w1, p.w2, p.b3, block.resSeq[0].running_var):
        v = w.to(t, meta)
        assert (v.device, v.shape, v.stride(), v.storage_offset()) == \
            (meta, t.shape, t.stride(), t.storage_offset())
    conv = block.resSeq[5]
    k = w.kernel(conv, int8.prepared_kernel(conv), meta)
    assert k.kq.device == meta and k.scale.device == meta
    copied = spatial.COPIED_BYTES
    assert w.kernel(conv, int8.prepared_kernel(conv), meta) is k
    w.refresh()
    assert spatial.COPIED_BYTES == copied
    with torch.no_grad():
        conv.weight.mul_(2.0)
    w.refresh()
    assert spatial.COPIED_BYTES - copied == sum(storages.values())
    assert w.kernel(conv, int8.prepared_kernel(conv), meta) is not k
    before = spatial.COPIED_BYTES
    spatial.spatial_forward(model, images, MESHES["S2"])
    assert spatial.COPIED_BYTES == before
