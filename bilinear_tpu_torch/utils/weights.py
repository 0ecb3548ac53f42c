"""Carry weights between the JAX package's parameter trees and the port's
``state_dict``s: ``BilinearUnit``, the torch7 detector and the
pre-activation detector (the port's own copy of those halves of
``bilinear_tpu/utils/torch_compat.py``), and HRNet's tree, which JAX does
not have (``HOURGLASS`` names each detector variant's converters).

JAX tree -> state_dict:
- Dense ``kernel`` (in, out)            -> Linear ``weight`` (out, in)
- BN ``scale``/``bias`` (params)        -> BN ``weight``/``bias``
- BN ``mean``/``var``/``count`` (stats) -> ``running_mean``/``running_var``/
                                           ``num_batches_tracked``
- Adam ``mu``/``nu`` (the params tree)  -> ``exp_avg``/``exp_avg_sq`` per
                                           parameter
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, Mapping, NamedTuple,
                    Tuple)

import numpy as np
import torch

NUM_BLOCKS = 2


def _layers() -> Iterator[Tuple[str, str]]:
    """(JAX module name, state_dict prefix) of every HeavyLinear, in the
    reference's registration order."""
    yield "encode", "encode"
    for b in range(NUM_BLOCKS):
        for s in range(2):
            yield f"bilinear_{b}_{s}", f"bilinear.{b}.{s}"


DENSE_W = "dense_w"  # a Linear weight (out, in), a flax kernel (in, out)


def bilinear_param_paths():
    """(state_dict key, JAX path, kind) of every trained parameter of
    BilinearUnit, as ``torch7_param_paths``; kind ``dense_w`` is a Linear
    weight (transposed between the two layouts)."""
    for ours, theirs in _layers():
        yield f"{theirs}.0.weight", (ours, "linear", "kernel"), DENSE_W
        yield f"{theirs}.0.bias", (ours, "linear", "bias"), "plain"
        yield f"{theirs}.1.weight", (ours, "bn", "scale"), "plain"
        yield f"{theirs}.1.bias", (ours, "bn", "bias"), "plain"
    yield "decode.weight", ("decode", "kernel"), DENSE_W
    yield "decode.bias", ("decode", "bias"), "plain"


def _tensor(a) -> torch.Tensor:
    # Copy: the tree may hold read-only or shared numpy buffers.
    return torch.from_numpy(np.array(np.asarray(a)))


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.array(t)


def bilinear_from_jax(params: Mapping[str, Any],
                      batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``{params, batch_stats}`` (numpy leaves) -> port ``state_dict``."""
    named = bilinear_params_from_jax(params)
    sd: Dict[str, torch.Tensor] = {}
    for ours, theirs in _layers():
        st = batch_stats[ours]["bn"]
        for k in ("0.weight", "0.bias", "1.weight", "1.bias"):
            sd[f"{theirs}.{k}"] = named[f"{theirs}.{k}"]
        sd[f"{theirs}.1.running_mean"] = _tensor(st["mean"])
        sd[f"{theirs}.1.running_var"] = _tensor(st["var"])
        sd[f"{theirs}.1.num_batches_tracked"] = torch.tensor(
            int(np.asarray(st["count"])), dtype=torch.int64
        )
    sd["decode.weight"] = named["decode.weight"]
    sd["decode.bias"] = named["decode.bias"]
    return sd


def bilinear_params_to_jax(tensors: Mapping[str, Any]) -> Dict[str, Any]:
    """The trained parameters of a ``state_dict``-keyed mapping (a
    ``state_dict``, or one tensor per parameter such as Adam's moments) ->
    the JAX ``params`` tree (Dense kernels transposed to (in, out))."""
    params: Dict[str, Any] = {}
    for key, path, kind in bilinear_param_paths():
        put_leaf(params, path, leaf_to_jax(tensors[key], kind))
    return params


def bilinear_params_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """Inverse of ``bilinear_params_to_jax``: {parameter name: tensor}."""
    return {key: leaf_from_jax(get_leaf(params, path), kind)
            for key, path, kind in bilinear_param_paths()}


def bilinear_to_jax(state_dict: Mapping[str, Any]):
    """Port ``state_dict`` -> JAX ``(params, batch_stats)`` as numpy trees.
    Exact inverse of ``bilinear_from_jax`` (``count`` comes back int32, the
    JAX package's dtype)."""
    sd = state_dict
    stats: Dict[str, Any] = {}
    for ours, theirs in _layers():
        stats[ours] = {
            "bn": {
                "mean": _numpy(sd[f"{theirs}.1.running_mean"]),
                "var": _numpy(sd[f"{theirs}.1.running_var"]),
                "count": _numpy(sd[f"{theirs}.1.num_batches_tracked"]).astype(
                    np.int32
                ),
            }
        }
    return bilinear_params_to_jax(sd), stats


def bilinear_opt_to_jax(count: int, exp_avg: Mapping[str, Any],
                        exp_avg_sq: Mapping[str, Any]) -> Dict[str, Any]:
    """Adam's state -> the JAX optimizer payload ``(EmptyState,
    TorchAdamState(count, mu, nu))`` as ``{'0': {}, '1': {'count', 'mu',
    'nu'}}``, the moments in the parameter tree's layout. ``exp_avg`` /
    ``exp_avg_sq`` map each parameter name to its moment."""
    return {"0": {}, "1": {"count": np.asarray(count, np.int32),
                           "mu": bilinear_params_to_jax(exp_avg),
                           "nu": bilinear_params_to_jax(exp_avg_sq)}}


def bilinear_opt_from_jax(optimizer: Mapping[str, Any]):
    """Exact inverse of ``bilinear_opt_to_jax``: (count, exp_avg,
    exp_avg_sq), the moments keyed by parameter name."""
    adam = optimizer["1"]
    return (int(np.asarray(adam["count"])),
            bilinear_params_from_jax(adam["mu"]),
            bilinear_params_from_jax(adam["nu"]))


def bilinear_optimizer_from_torch(opt_state_dict: Mapping[str, Any]):
    """``torch.optim.Adam.state_dict()`` of the reference's BilinearUnit ->
    (count, exp_avg, exp_avg_sq), the moments keyed by parameter name
    (empty before the first step). The integer ids follow
    ``model.parameters()`` order, ``bilinear_param_paths``'s; torch keeps a
    step per parameter and the reference steps them together, so any one
    is the shared count (JAX's ``bilinear_optimizer_from_torch``)."""
    keys = [key for key, _, _ in bilinear_param_paths()]
    ids = [i for group in opt_state_dict["param_groups"]
           for i in group["params"]]
    if len(ids) != len(keys):
        raise ValueError(f"an Adam state of {len(ids)} parameters for the "
                         f"{len(keys)} of BilinearUnit")
    count, exp_avg, exp_avg_sq = 0, {}, {}
    for pid, key in zip(ids, keys):
        entry = opt_state_dict["state"].get(pid, {})
        if not entry:
            continue
        count = int(np.asarray(_numpy(entry["step"])))
        exp_avg[key] = _tensor(_numpy(entry["exp_avg"]))
        exp_avg_sq[key] = _tensor(_numpy(entry["exp_avg_sq"]))
    return count, exp_avg, exp_avg_sq


def reference_bilinear_payload(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's torch ``{epoch}.save`` dict (``{'epoch', 'step',
    'state', 'optimizer'}``, its train_bilinear.py:96-104) -> a ``.save``
    payload of the JAX layout, Adam's moments and count included."""
    params, stats = bilinear_to_jax(ckpt["state"])
    count, exp_avg, exp_avg_sq = bilinear_optimizer_from_torch(
        ckpt["optimizer"])
    return {"epoch": int(ckpt["epoch"]), "step": int(ckpt["step"]),
            "state": {"params": params, "batch_stats": stats},
            "optimizer": bilinear_opt_to_jax(count, exp_avg, exp_avg_sq)
            if exp_avg else {}}


def load_reference_bilinear_checkpoint(path: str, state):
    """Load the reference's torch ``{epoch}.save`` at ``path`` into a
    ``train/bilinear.py::TrainState`` in place: weights, BN statistics,
    Adam's moments and count, and the step (JAX's
    ``load_reference_bilinear_checkpoint``). Returns (state, epoch)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    payload = reference_bilinear_payload(ckpt)
    state.restore(payload)
    return state, payload["epoch"]


# ---------------------------------------------------------------------------
# The torch7 hourglass detector (the port's copy of the hourglass_torch7
# halves of bilinear_tpu/utils/torch_compat.py, between the JAX tree and
# the port's MainModel state_dict):
# - Conv ``kernel`` (kh, kw, in, out)  -> Conv2d ``weight`` (out, in, kh, kw)
# - BN as for BilinearUnit.
# The JAX tree has no ``conv_skip`` for an identity ResModule (flax never
# creates an unused module's parameters); the state_dict always has one
# (the reference registers it), filled with zeros on the way in and dropped
# on the way out.
# ---------------------------------------------------------------------------

CONV, BN, SKIP = "conv", "bn", "skip"


def _slot(slot: str, k: int) -> str:
    return slot if k == 0 else f"{slot}_m{k}"


def _torch7_leaves(n_stacks: int, depth: int, n_modules: int,
                   features: int):
    """(JAX module path, state_dict prefix, kind, (ci, co) or None) of every
    conv and BN of MainModel, in the reference's registration order."""
    def res_module(ours, theirs, ci, co):
        yield ours + ("conv_skip",), theirs + ".conv_skip", SKIP, (ci, co)
        seq = ((BN, "bn1"), None, (CONV, "conv1"), (BN, "bn2"), None,
               (CONV, "conv2"), (BN, "bn3"), None, (CONV, "conv3"))
        for j, item in enumerate(seq):  # None: the ReLUs
            if item is not None:
                kind, name = item
                yield ours + (name,), f"{theirs}.resSeq.{j}", kind, None

    def hourglass(ours, theirs, d):
        for slot in ("res1", "res2", "res3"):
            for k in range(n_modules):
                yield from res_module(ours + (_slot(slot, k),),
                                      f"{theirs}.{slot}.{k}", features,
                                      features)
        if d > 1:
            yield from hourglass(ours + ("sub",), theirs + ".subHourglass",
                                 d - 1)
        else:
            for k in range(n_modules):
                yield from res_module(ours + (_slot("waist", k),),
                                      f"{theirs}.resWaist.{k}", features,
                                      features)

    yield ("stem_conv",), "beforeHourglass.0", CONV, None
    yield ("stem_bn",), "beforeHourglass.1", BN, None
    yield from res_module(("stem_res1",), "beforeHourglass.3", 64, 128)
    yield from res_module(("stem_res2",), "beforeHourglass.5", 128, 128)
    yield from res_module(("stem_res3",), "beforeHourglass.6", 128, features)
    for i in range(n_stacks):
        yield from hourglass((f"hg_{i}",), f"hgArray.{i}", depth)
    for i in range(n_stacks):
        yield (f"lin_{i}", "conv"), f"linArray.{i}.0", CONV, None
        yield (f"lin_{i}", "bn"), f"linArray.{i}.1", BN, None
    for i in range(n_stacks):
        yield (f"htmap_{i}",), f"htmapArray.{i}", CONV, None
    for i in range(n_stacks - 1):
        yield (f"ll_bar_{i}",), f"llBarArray.{i}", CONV, None
    for i in range(n_stacks - 1):
        yield (f"htmap_bar_{i}",), f"htmapBarArray.{i}", CONV, None


def get_leaf(tree, path):
    for key in path:
        if tree is None or key not in tree:
            return None
        tree = tree[key]
    return tree


def put_leaf(tree, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def torch7_config_of_jax(params: Mapping[str, Any]) -> Dict[str, int]:
    """n_stacks, depth, n_modules, features and n_joints of a JAX tree."""
    n_stacks = sum(1 for k in params
                   if k.startswith("htmap_") and not k.startswith("htmap_bar_"))
    depth, node = 1, params["hg_0"]
    while "sub" in node:
        depth, node = depth + 1, node["sub"]
    n_modules = 1
    while f"res1_m{n_modules}" in params["hg_0"]:
        n_modules += 1
    shape = np.shape(params["htmap_0"]["kernel"])
    return dict(n_stacks=n_stacks, depth=depth, n_modules=n_modules,
                features=int(shape[2]), n_joints=int(shape[3]))


def torch7_config_of_state_dict(sd: Mapping[str, Any]) -> Dict[str, int]:
    """The same, of a MainModel state_dict."""
    n_stacks = sum(1 for k in sd if k.startswith("htmapArray.")
                   and k.endswith(".weight"))
    depth = 1
    while f"hgArray.0{'.subHourglass' * depth}.res1.0.resSeq.0.weight" in sd:
        depth += 1
    n_modules = 1
    while f"hgArray.0.res1.{n_modules}.resSeq.0.weight" in sd:
        n_modules += 1
    shape = tuple(sd["htmapArray.0.weight"].shape)
    return dict(n_stacks=n_stacks, depth=depth, n_modules=n_modules,
                features=int(shape[1]), n_joints=int(shape[0]))


def torch7_param_paths(cfg: Mapping[str, int]):
    """(state_dict key, JAX path, kind) of every trained parameter: the
    leaves the JAX optimizer state holds. kind is "conv_w" for a conv
    weight (transposed between the two layouts) else "plain"."""
    leaves = _torch7_leaves(cfg["n_stacks"], cfg["depth"], cfg["n_modules"],
                            cfg["features"])
    for path, prefix, kind, chans in leaves:
        if kind == SKIP and chans[0] == chans[1]:
            continue
        if kind == BN:
            yield prefix + ".weight", path + ("scale",), "plain"
            yield prefix + ".bias", path + ("bias",), "plain"
        else:
            yield prefix + ".weight", path + ("kernel",), "conv_w"
            yield prefix + ".bias", path + ("bias",), "plain"


def conv_to_jax(w) -> np.ndarray:
    """Conv2d weight (out, in, kh, kw) -> flax kernel (kh, kw, in, out)."""
    return _numpy(w).transpose(2, 3, 1, 0).copy()


def conv_from_jax(k) -> torch.Tensor:
    return _tensor(np.asarray(k).transpose(3, 2, 0, 1))


def hourglass_torch7_from_jax(params: Mapping[str, Any],
                              batch_stats: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """JAX MainModel ``{params, batch_stats}`` (numpy leaves) -> the port's
    MainModel ``state_dict``."""
    cfg = torch7_config_of_jax(params)
    sd: Dict[str, torch.Tensor] = {}
    for path, prefix, kind, chans in _torch7_leaves(
            cfg["n_stacks"], cfg["depth"], cfg["n_modules"],
            cfg["features"]):
        if kind == BN:
            p, st = get_leaf(params, path), get_leaf(batch_stats, path)
            sd[prefix + ".weight"] = _tensor(p["scale"])
            sd[prefix + ".bias"] = _tensor(p["bias"])
            sd[prefix + ".running_mean"] = _tensor(st["mean"])
            sd[prefix + ".running_var"] = _tensor(st["var"])
            sd[prefix + ".num_batches_tracked"] = torch.tensor(
                int(np.asarray(st["count"])), dtype=torch.int64)
            continue
        node = get_leaf(params, path)
        if node is None:  # identity conv_skip: absent in JAX
            ci, co = chans
            sd[prefix + ".weight"] = torch.zeros((co, ci, 1, 1))
            sd[prefix + ".bias"] = torch.zeros(co)
            continue
        sd[prefix + ".weight"] = conv_from_jax(node["kernel"])
        sd[prefix + ".bias"] = _tensor(node["bias"])
    return sd


def hourglass_torch7_to_jax(state_dict: Mapping[str, Any]):
    """Port MainModel ``state_dict`` -> JAX ``(params, batch_stats)`` numpy
    trees; exact inverse of ``hourglass_torch7_from_jax`` (``count`` comes
    back int32; an identity block's conv_skip is dropped)."""
    sd = state_dict
    cfg = torch7_config_of_state_dict(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for path, prefix, kind, chans in _torch7_leaves(
            cfg["n_stacks"], cfg["depth"], cfg["n_modules"],
            cfg["features"]):
        if kind == SKIP and chans[0] == chans[1]:
            continue
        if kind == BN:
            put_leaf(params, path, {"scale": _numpy(sd[prefix + ".weight"]),
                                "bias": _numpy(sd[prefix + ".bias"])})
            put_leaf(stats, path, {
                "mean": _numpy(sd[prefix + ".running_mean"]),
                "var": _numpy(sd[prefix + ".running_var"]),
                "count": _numpy(sd[prefix + ".num_batches_tracked"])
                .astype(np.int32),
            })
            continue
        put_leaf(params, path, {"kernel": conv_to_jax(sd[prefix + ".weight"]),
                            "bias": _numpy(sd[prefix + ".bias"])})
    return params, stats


# ---------------------------------------------------------------------------
# The pre-activation hourglass (the port's copy of hourglass_from_torch /
# hourglass_to_torch_state of bilinear_tpu/utils/torch_compat.py, between
# the JAX StackedHourglass tree and the port's state_dict). Convs are
# bias-less but for the heatmap heads and the 1x1 ``skip`` of a ResUnit
# that changes the channel count (present on both sides only there); the
# stem conv has no BN after it. Module k > 0 of an hourglass slot is the
# JAX tree's ``{slot}_m{k}`` and the state_dict's ``{list}_m{k}``.
# ---------------------------------------------------------------------------

CONV_B = "conv_b"  # a conv with a bias


def _preact_leaves(n_stacks: int, depth: int, n_modules: int,
                   features: int):
    """(JAX module path, state_dict prefix, kind) of every conv and BN of
    StackedHourglass, in the reference's registration order."""
    def light(ours, theirs, bias=False):
        yield ours + ("bn",), theirs + ".0", BN
        yield ours + ("conv",), theirs + ".2", CONV_B if bias else CONV

    def res_unit(ours, theirs, ci, co):
        for k in range(3):
            yield from light(ours + (f"light{k + 1}",), f"{theirs}.conv.{k}")
        if ci != co:
            yield ours + ("skip",), theirs + ".skip", CONV_B

    def unit(ours, theirs):
        yield from res_unit(ours, theirs, features, features)

    def hourglass(ours, theirs):
        for t in range(depth):
            yield from unit(ours + (f"skip_{t}",),
                            f"{theirs}.skip_connection.{t}")
        for t in range(depth):
            yield from unit(ours + (f"down_{t}",), f"{theirs}.downscale.{t}.1")
        yield from unit(ours + ("waist",), f"{theirs}.res")
        for t in range(depth):
            yield from unit(ours + (f"up_{t}",), f"{theirs}.upscale.{t}.0")
        for k in range(1, n_modules):
            for t in range(depth):
                yield from unit(ours + (f"skip_{t}_m{k}",),
                                f"{theirs}.skip_connection_m{k}.{t}")
            for t in range(depth):
                yield from unit(ours + (f"down_{t}_m{k}",),
                                f"{theirs}.downscale_m{k}.{t}")
            yield from unit(ours + (f"waist_m{k}",), f"{theirs}.res_m{k}")
            for t in range(depth):
                yield from unit(ours + (f"up_{t}_m{k}",),
                                f"{theirs}.upscale_m{k}.{t}")

    yield ("stem_conv",), "feature_extraction.0", CONV
    yield from res_unit(("stem_res1",), "feature_extraction.1", 64, 128)
    yield from res_unit(("stem_res2",), "feature_extraction.3", 128, 128)
    yield from res_unit(("stem_res3",), "feature_extraction.4", 128, features)
    for i in range(n_stacks):
        yield from hourglass((f"hg_{i}",), f"hourglass.{i}")
    for i in range(n_stacks):
        yield from unit((f"prev_{i}", "res"), f"prev_heatmap.{i}.0")
        yield from light((f"prev_{i}", "light"), f"prev_heatmap.{i}.1")
    for i in range(n_stacks):
        yield from light((f"heatmap_{i}",), f"heatmap_intermediate.{i}",
                         bias=True)
    for i in range(n_stacks):
        yield from light((f"after_{i}",), f"after_heatmap.{i}")
    for i in range(n_stacks):
        yield from light((f"skip_{i}",), f"skip_intermediate.{i}")


def preact_config_of_jax(params: Mapping[str, Any]) -> Dict[str, int]:
    """n_stacks, depth, n_modules, features and n_joints of a JAX
    StackedHourglass tree."""
    n_stacks = sum(1 for k in params if k.startswith("heatmap_"))
    depth = 0
    while f"skip_{depth}" in params["hg_0"]:
        depth += 1
    n_modules = 1
    while f"skip_0_m{n_modules}" in params["hg_0"]:
        n_modules += 1
    shape = np.shape(params["heatmap_0"]["conv"]["kernel"])
    return dict(n_stacks=n_stacks, depth=depth, n_modules=n_modules,
                features=int(shape[2]), n_joints=int(shape[3]))


def preact_config_of_state_dict(sd: Mapping[str, Any]) -> Dict[str, int]:
    """The same, of a StackedHourglass state_dict."""
    n_stacks = sum(1 for k in sd if k.startswith("heatmap_intermediate.")
                   and k.endswith(".2.weight"))
    depth = 0
    while f"hourglass.0.skip_connection.{depth}.conv.0.0.weight" in sd:
        depth += 1
    n_modules = 1
    while f"hourglass.0.skip_connection_m{n_modules}.0.conv.0.0.weight" \
            in sd:
        n_modules += 1
    shape = tuple(sd["heatmap_intermediate.0.2.weight"].shape)
    return dict(n_stacks=n_stacks, depth=depth, n_modules=n_modules,
                features=int(shape[1]), n_joints=int(shape[0]))


def _preact_leaves_of(cfg: Mapping[str, int]):
    return _preact_leaves(cfg["n_stacks"], cfg["depth"], cfg["n_modules"],
                          cfg["features"])


def preact_param_paths(cfg: Mapping[str, int]):
    """(state_dict key, JAX path, kind) of every trained parameter of
    StackedHourglass, as ``torch7_param_paths``."""
    for path, prefix, kind in _preact_leaves_of(cfg):
        if kind == BN:
            yield prefix + ".weight", path + ("scale",), "plain"
            yield prefix + ".bias", path + ("bias",), "plain"
            continue
        yield prefix + ".weight", path + ("kernel",), "conv_w"
        if kind == CONV_B:
            yield prefix + ".bias", path + ("bias",), "plain"


def hourglass_preact_from_jax(params: Mapping[str, Any],
                              batch_stats: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """JAX StackedHourglass ``{params, batch_stats}`` (numpy leaves) -> the
    port's StackedHourglass ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, prefix, kind in _preact_leaves_of(preact_config_of_jax(params)):
        node = get_leaf(params, path)
        if kind == BN:
            st = get_leaf(batch_stats, path)
            sd[prefix + ".weight"] = _tensor(node["scale"])
            sd[prefix + ".bias"] = _tensor(node["bias"])
            sd[prefix + ".running_mean"] = _tensor(st["mean"])
            sd[prefix + ".running_var"] = _tensor(st["var"])
            sd[prefix + ".num_batches_tracked"] = torch.tensor(
                int(np.asarray(st["count"])), dtype=torch.int64)
            continue
        sd[prefix + ".weight"] = conv_from_jax(node["kernel"])
        if kind == CONV_B:
            sd[prefix + ".bias"] = _tensor(node["bias"])
    return sd


def hourglass_preact_to_jax(state_dict: Mapping[str, Any]):
    """Port StackedHourglass ``state_dict`` -> JAX ``(params,
    batch_stats)`` numpy trees; exact inverse of
    ``hourglass_preact_from_jax`` (``count`` comes back int32)."""
    sd = state_dict
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for path, prefix, kind in _preact_leaves_of(
            preact_config_of_state_dict(sd)):
        if kind == BN:
            put_leaf(params, path, {"scale": _numpy(sd[prefix + ".weight"]),
                                    "bias": _numpy(sd[prefix + ".bias"])})
            put_leaf(stats, path, {
                "mean": _numpy(sd[prefix + ".running_mean"]),
                "var": _numpy(sd[prefix + ".running_var"]),
                "count": _numpy(sd[prefix + ".num_batches_tracked"])
                .astype(np.int32),
            })
            continue
        node = {"kernel": conv_to_jax(sd[prefix + ".weight"])}
        if kind == CONV_B:
            node["bias"] = _numpy(sd[prefix + ".bias"])
        put_leaf(params, path, node)
    return params, stats


# ---------------------------------------------------------------------------
# HRNet (models/hrnet.py), which JAX does not have. Its ``.save`` tree keeps
# the ``{"params", "batch_stats"}`` form under the published module names,
# one tree level per dotted component (``stage2.0.branches.1.3.conv1`` is
# params["stage2"]["0"]["branches"]["1"]["3"]["conv1"]): a conv is
# ``{kernel (kh, kw, in, out)[, bias]}``, a BN ``{scale, bias}`` with
# ``{mean, var, count}`` in the statistics.
# ---------------------------------------------------------------------------

def hrnet_config_of_jax(params: Mapping[str, Any]) -> Dict[str, int]:
    """width and n_joints of an HRNet tree (its ``final_layer``)."""
    shape = np.shape(params["final_layer"]["kernel"])
    return dict(width=int(shape[2]), n_joints=int(shape[3]))


def hrnet_config_of_state_dict(sd: Mapping[str, Any]) -> Dict[str, int]:
    """The same, of a PoseHighResolutionNet state_dict."""
    shape = tuple(sd["final_layer.weight"].shape)
    return dict(width=int(shape[1]), n_joints=int(shape[0]))


def hrnet_param_paths(cfg: Mapping[str, int]):
    """(state_dict key, tree path, kind) of every trained parameter of
    PoseHighResolutionNet, as ``torch7_param_paths``, in its registration
    order (the model built on the meta device)."""
    from bilinear_tpu_torch.models.hrnet import PoseHighResolutionNet

    with torch.device("meta"):
        model = PoseHighResolutionNet(cfg["width"], cfg["n_joints"])
    for key, p in model.named_parameters():
        prefix, name = key.rsplit(".", 1)
        path = tuple(prefix.split("."))
        if p.dim() == 4:
            yield key, path + ("kernel",), "conv_w"
        elif p.dim() == 1 and name == "weight":
            yield key, path + ("scale",), "plain"
        else:
            yield key, path + ("bias",), "plain"


def _walk(tree: Mapping[str, Any], path: tuple = ()):
    """(path, node) of every conv (a ``kernel``) and BN (a ``scale``) node;
    an array that is a leaf of its own (ViTPose's ``pos_embed``) is none."""
    if not isinstance(tree, Mapping):
        return
    if "kernel" in tree or "scale" in tree:
        yield path, tree
        return
    for key, sub in tree.items():
        yield from _walk(sub, path + (key,))


def hrnet_from_jax(params: Mapping[str, Any],
                   batch_stats: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """An HRNet ``{params, batch_stats}`` tree (numpy leaves) -> the port's
    PoseHighResolutionNet ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, node in _walk(params):
        prefix = ".".join(path)
        if "scale" in node:
            st = get_leaf(batch_stats, path)
            sd[prefix + ".weight"] = _tensor(node["scale"])
            sd[prefix + ".bias"] = _tensor(node["bias"])
            sd[prefix + ".running_mean"] = _tensor(st["mean"])
            sd[prefix + ".running_var"] = _tensor(st["var"])
            sd[prefix + ".num_batches_tracked"] = torch.tensor(
                int(np.asarray(st["count"])), dtype=torch.int64)
            continue
        sd[prefix + ".weight"] = conv_from_jax(node["kernel"])
        if "bias" in node:
            sd[prefix + ".bias"] = _tensor(node["bias"])
    return sd


def hrnet_to_jax(state_dict: Mapping[str, Any]):
    """Port PoseHighResolutionNet ``state_dict`` -> ``(params,
    batch_stats)`` numpy trees; exact inverse of ``hrnet_from_jax``
    (``count`` comes back int32)."""
    sd = state_dict
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in sd.items():
        prefix, name = key.rsplit(".", 1)
        path = tuple(prefix.split("."))
        if prefix + ".running_mean" in sd:  # a BN
            if name == "weight":
                put_leaf(params, path + ("scale",), _numpy(t))
            elif name == "bias":
                put_leaf(params, path + ("bias",), _numpy(t))
            elif name == "num_batches_tracked":
                put_leaf(stats, path + ("count",),
                         _numpy(t).astype(np.int32))
            else:
                put_leaf(stats, path + (name[len("running_"):],),
                         _numpy(t))
        elif name == "weight":
            put_leaf(params, path + ("kernel",), conv_to_jax(t))
        else:
            put_leaf(params, path + ("bias",), _numpy(t))
    return params, stats


# ---------------------------------------------------------------------------
# ViTPose (models/vitpose.py), which JAX does not have. Its ``.save`` tree
# keeps the ``{"params", "batch_stats"}`` form under the published module
# names, one tree level per dotted component (``backbone.blocks.3.attn.qkv``
# is params["backbone"]["blocks"]["3"]["attn"]["qkv"]): a Linear is
# ``{kernel (in, out), bias}``, a conv ``{kernel (kh, kw, in, out), bias}``,
# a deconvolution (under ``deconv_layers``) ``{kernel (kh, kw, in, out)}``
# of ConvTranspose2d's (in, out, kh, kw) weight, a LayerNorm ``{scale,
# bias}``, a BN ``{scale, bias}`` with ``{mean, var, count}`` in the
# statistics, and ``pos_embed`` the array itself.
# ---------------------------------------------------------------------------

DECONV_W = "deconv_w"  # ConvTranspose2d (in, out, kh, kw), (kh, kw, in, out)


def vitpose_config_of_jax(params: Mapping[str, Any]) -> Dict[str, int]:
    """embed_dim, depth, tokens and n_joints of a ViTPose tree."""
    pos = np.shape(params["backbone"]["pos_embed"])
    return dict(embed_dim=int(pos[2]),
                depth=len(params["backbone"]["blocks"]),
                tokens=int(pos[1]) - 1, n_joints=int(np.shape(
                    params["keypoint_head"]["final_layer"]["kernel"])[3]))


def vitpose_config_of_state_dict(sd: Mapping[str, Any]) -> Dict[str, int]:
    """The same, of a ViTPose state_dict."""
    pos = tuple(sd["backbone.pos_embed"].shape)
    depth = len({k.split(".")[2] for k in sd
                 if k.startswith("backbone.blocks.")})
    return dict(embed_dim=int(pos[2]), depth=depth, tokens=int(pos[1]) - 1,
                n_joints=int(sd["keypoint_head.final_layer.weight"].shape[0]))


def vitpose_param_paths(cfg: Mapping[str, int]):
    """(state_dict key, tree path, kind) of every trained parameter of
    ViTPose, as ``torch7_param_paths``, in its registration order; ``cfg``
    is ``vitpose_config_of_*``'s (the shapes do not depend on it)."""
    def module(prefix: str, weight_kind: str, bias: bool = True):
        path = tuple(prefix.split("."))
        yield prefix + ".weight", path + (
            "scale" if weight_kind == "plain" else "kernel",), weight_kind
        if bias:
            yield prefix + ".bias", path + ("bias",), "plain"

    yield "backbone.pos_embed", ("backbone", "pos_embed"), "plain"
    yield from module("backbone.patch_embed.proj", "conv_w")
    for i in range(cfg["depth"]):
        p = f"backbone.blocks.{i}."
        for name, kind in (("norm1", "plain"), ("attn.qkv", DENSE_W),
                           ("attn.proj", DENSE_W), ("norm2", "plain"),
                           ("mlp.fc1", DENSE_W), ("mlp.fc2", DENSE_W)):
            yield from module(p + name, kind)
    yield from module("backbone.last_norm", "plain")
    for k in (0, 3):
        p = f"keypoint_head.deconv_layers.{k}"
        yield from module(p, DECONV_W, bias=False)
        yield from module(f"keypoint_head.deconv_layers.{k + 1}", "plain")
    yield from module("keypoint_head.final_layer", "conv_w")


def vitpose_from_jax(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """A ViTPose ``{params, batch_stats}`` tree (numpy leaves) -> the port's
    ViTPose ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {
        "backbone.pos_embed": _tensor(params["backbone"]["pos_embed"])}
    for path, node in _walk(params):
        prefix = ".".join(path)
        if "scale" in node:
            sd[prefix + ".weight"] = _tensor(node["scale"])
            sd[prefix + ".bias"] = _tensor(node["bias"])
            if "deconv_layers" not in path:  # a LayerNorm
                continue
            st = get_leaf(batch_stats, path)
            sd[prefix + ".running_mean"] = _tensor(st["mean"])
            sd[prefix + ".running_var"] = _tensor(st["var"])
            sd[prefix + ".num_batches_tracked"] = torch.tensor(
                int(np.asarray(st["count"])), dtype=torch.int64)
            continue
        kernel = np.asarray(node["kernel"])
        kind = DENSE_W if kernel.ndim == 2 else (
            DECONV_W if "deconv_layers" in path else "conv_w")
        sd[prefix + ".weight"] = leaf_from_jax(kernel, kind)
        if "bias" in node:
            sd[prefix + ".bias"] = _tensor(node["bias"])
    return sd


def vitpose_to_jax(state_dict: Mapping[str, Any]):
    """Port ViTPose ``state_dict`` -> ``(params, batch_stats)`` numpy
    trees; exact inverse of ``vitpose_from_jax`` (``count`` comes back
    int32)."""
    sd = state_dict
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in sd.items():
        if key == "backbone.pos_embed":
            put_leaf(params, ("backbone", "pos_embed"), _numpy(t))
            continue
        prefix, name = key.rsplit(".", 1)
        path = tuple(prefix.split("."))
        if name == "weight" and t.dim() == 1:  # a BN's or a LayerNorm's
            put_leaf(params, path + ("scale",), _numpy(t))
        elif name == "num_batches_tracked":
            put_leaf(stats, path + ("count",), _numpy(t).astype(np.int32))
        elif name.startswith("running_"):
            put_leaf(stats, path + (name[len("running_"):],), _numpy(t))
        elif name == "weight":
            kind = DENSE_W if t.dim() == 2 else (
                DECONV_W if "deconv_layers" in path else "conv_w")
            put_leaf(params, path + ("kernel",), leaf_to_jax(t, kind))
        else:
            put_leaf(params, path + ("bias",), _numpy(t))
    return params, stats


class HourglassConverters(NamedTuple):
    """One model's converters between the two packages (a detector
    variant's, or End2End's: ``end2end_converters``)."""

    from_jax: Callable
    to_jax: Callable
    config_of_jax: Callable
    config_of_state_dict: Callable
    param_paths: Callable


HOURGLASS = {
    "torch7": HourglassConverters(
        hourglass_torch7_from_jax, hourglass_torch7_to_jax,
        torch7_config_of_jax, torch7_config_of_state_dict,
        torch7_param_paths),
    "preact": HourglassConverters(
        hourglass_preact_from_jax, hourglass_preact_to_jax,
        preact_config_of_jax, preact_config_of_state_dict,
        preact_param_paths),
    "hrnet": HourglassConverters(
        hrnet_from_jax, hrnet_to_jax, hrnet_config_of_jax,
        hrnet_config_of_state_dict, hrnet_param_paths),
    "vitpose": HourglassConverters(
        vitpose_from_jax, vitpose_to_jax, vitpose_config_of_jax,
        vitpose_config_of_state_dict, vitpose_param_paths),
}


def detector_variant_of_jax(params: Mapping[str, Any]) -> str:
    """'torch7', 'preact', 'hrnet' or 'vitpose': which detector a parameter
    tree holds."""
    if "htmap_0" in params:
        return "torch7"
    if "heatmap_0" in params:
        return "preact"
    if "final_layer" in params:
        return "hrnet"
    if "backbone" in params:
        return "vitpose"
    raise ValueError("the tree is no detector's (no htmap_0, heatmap_0, "
                     "final_layer or backbone)")


# ---------------------------------------------------------------------------
# End2End: the detector's tree under ``hourglass`` and BilinearUnit's under
# ``bilinear``, on both sides (the JAX module's submodule names and the
# port's state_dict prefixes). The optimizer holds one RMSprop square_avg
# per trained parameter of the whole tree.
# ---------------------------------------------------------------------------

def leaf_to_jax(t, kind: str) -> np.ndarray:
    """A parameter-shaped tensor (the parameter, or an optimizer moment of
    it) in the JAX layout of its ``kind``."""
    if kind == "conv_w":
        return conv_to_jax(t)
    if kind == DECONV_W:
        return _numpy(t).transpose(2, 3, 0, 1).copy()
    if kind == DENSE_W:
        return _numpy(t).T.copy()
    return _numpy(t)


def leaf_from_jax(leaf, kind: str) -> torch.Tensor:
    """Inverse of ``leaf_to_jax``, as an f32 tensor (f64 for an f64 leaf,
    as ``conv_from_jax`` keeps its leaf's type)."""
    if kind == "conv_w":
        return conv_from_jax(leaf)
    if kind == DECONV_W:
        return _tensor(np.asarray(leaf).transpose(2, 3, 0, 1))
    a = np.asarray(leaf)
    a = a if a.dtype == np.float64 else a.astype(np.float32)
    return _tensor(a.T if kind == DENSE_W else a)


def _sub(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def end2end_from_jax(params: Mapping[str, Any],
                     batch_stats: Mapping[str, Any],
                     variant: str) -> Dict[str, torch.Tensor]:
    """JAX End2End ``{params, batch_stats}`` (numpy leaves) -> the port's
    End2End ``state_dict`` (``hourglass.*`` and ``bilinear.*``)."""
    found = detector_variant_of_jax(params["hourglass"])
    if found != variant:
        raise ValueError(f"the tree's detector is {found!r}, not "
                         f"{variant!r}")
    sd = {f"hourglass.{k}": v for k, v in HOURGLASS[variant].from_jax(
        params["hourglass"], batch_stats["hourglass"]).items()}
    sd.update({f"bilinear.{k}": v for k, v in bilinear_from_jax(
        params["bilinear"], batch_stats["bilinear"]).items()})
    return sd


def end2end_to_jax(state_dict: Mapping[str, Any], variant: str):
    """The port's End2End ``state_dict`` -> JAX ``(params, batch_stats)``
    numpy trees; exact inverse of ``end2end_from_jax``."""
    hp, hs = HOURGLASS[variant].to_jax(_sub(state_dict, "hourglass."))
    bp, bs = bilinear_to_jax(_sub(state_dict, "bilinear."))
    return {"hourglass": hp, "bilinear": bp}, {"hourglass": hs,
                                               "bilinear": bs}


def end2end_converters(variant: str) -> HourglassConverters:
    """End2End's converters with the ``variant`` detector: the detector's
    and BilinearUnit's, each under its subtree; ``param_paths`` lists the
    whole tree's trained parameters (the RMSprop state of both halves)."""
    det = HOURGLASS[variant]

    def param_paths(cfg):
        for key, path, kind in det.param_paths(cfg):
            yield "hourglass." + key, ("hourglass",) + tuple(path), kind
        for key, path, kind in bilinear_param_paths():
            yield "bilinear." + key, ("bilinear",) + path, kind

    return HourglassConverters(
        lambda p, s: end2end_from_jax(p, s, variant),
        lambda sd: end2end_to_jax(sd, variant),
        lambda p: det.config_of_jax(p["hourglass"]),
        lambda sd: det.config_of_state_dict(_sub(sd, "hourglass.")),
        param_paths)


def converters_of(model) -> HourglassConverters:
    """A port model's converters: End2End's (its ``end2end`` flag) or its
    detector variant's."""
    if getattr(model, "end2end", False):
        return end2end_converters(model.variant)
    return HOURGLASS[model.variant]


# ---------------------------------------------------------------------------
# Tensor-parallel shards of BilinearUnit (parallel/tp.py), in state_dict
# layout. Column-parallel (encode and the first layer of each residual
# pair): the Linear's output rows, its bias and its BN split over the model
# group. Row-parallel (the pair's second layer): the Linear weight's input
# columns split; its bias and BN replicated. decode replicated. The BN's
# num_batches_tracked is replicated everywhere. Adam's moments, keyed by
# parameter name, split the same way.
# ---------------------------------------------------------------------------

def _tp_split_dim(key: str):
    """The dim a BilinearUnit state_dict entry splits along under TP, or
    None for a replicated one."""
    if key.endswith("num_batches_tracked"):
        return None
    if key.startswith("encode.") or any(
            key.startswith(f"bilinear.{b}.0.") for b in range(NUM_BLOCKS)):
        return 0
    if any(key == f"bilinear.{b}.1.0.weight" for b in range(NUM_BLOCKS)):
        return 1
    return None


def bilinear_tp_shard(state: Mapping[str, Any], index: int, parts: int
                      ) -> Dict[str, Any]:
    """Model rank ``index``'s shard (of ``parts``) of a full BilinearUnit
    state_dict (or of a name -> moment map)."""
    out = {}
    for k, v in state.items():
        dim = _tp_split_dim(k)
        out[k] = v if dim is None else \
            torch.chunk(torch.as_tensor(v), parts, dim=dim)[index].clone()
    return out


def bilinear_tp_gather(shards) -> Dict[str, Any]:
    """Inverse of ``bilinear_tp_shard``: the full state from every model
    rank's shard, in rank order."""
    out = {}
    for k, v in shards[0].items():
        dim = _tp_split_dim(k)
        out[k] = v if dim is None else torch.cat([s[k] for s in shards],
                                                 dim=dim)
    return out


# ---------------------------------------------------------------------------
# Pipeline-parallel trees of the torch7 detector (JAX parallel/pp.py's
# split_pipeline_variables / merge_pipeline_variables, numpy): the stem's
# subtree, and the stacks' subtrees stacked on a leading (n_stacks,) axis
# under stack-index-free names, the final stack's absent feedback convs
# zero-filled. The port's pipeline (parallel/pp.py) runs a MainModel's own
# modules; these carry JAX pipeline trees across.
# ---------------------------------------------------------------------------

STEM_KEYS = ("stem_conv", "stem_bn", "stem_res1", "stem_res2", "stem_res3")
_STACK_KEYS = ("hg", "lin", "htmap", "ll_bar", "htmap_bar")


def _tree_map(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _zero_feedback(features: int, n_joints: int, col: str):
    if col != "params":
        return {}
    return {
        "ll_bar": {"kernel": np.zeros((1, 1, features, features), np.float32),
                   "bias": np.zeros((features,), np.float32)},
        "htmap_bar": {"kernel": np.zeros((1, 1, n_joints, features),
                                         np.float32),
                      "bias": np.zeros((features,), np.float32)},
    }


def split_pipeline_variables(variables, n_stacks: int, *, features: int = 256,
                             n_joints: int = 16):
    """MainModel JAX variables -> (stem_variables, stacked_stack_variables)."""
    per_stack = []
    for i in range(n_stacks):
        entry = {}
        for col, tree in variables.items():
            sub = {short: tree[f"{short}_{i}"] for short in _STACK_KEYS
                   if f"{short}_{i}" in tree}
            sub.update({k: v for k, v in _zero_feedback(
                features, n_joints, col).items() if k not in sub})
            entry[col] = sub
        per_stack.append(entry)
    stacked = _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *per_stack)
    stem = {col: {k: tree[k] for k in STEM_KEYS if k in tree}
            for col, tree in variables.items()}
    return stem, stacked


def merge_pipeline_variables(stem_vars, stacked_vars, n_stacks: int):
    """Inverse of ``split_pipeline_variables``; the final stack's
    zero-filled feedback convs are dropped."""
    out = {col: dict(tree) for col, tree in stem_vars.items()}
    for col in stacked_vars:
        for i in range(n_stacks):
            per = _tree_map(lambda a: np.asarray(a)[i], stacked_vars[col])
            for short in _STACK_KEYS:
                if short not in per:
                    continue
                if i == n_stacks - 1 and short in ("ll_bar", "htmap_bar"):
                    continue
                out.setdefault(col, {})[f"{short}_{i}"] = per[short]
    return out
