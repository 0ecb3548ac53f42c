"""The port's asynchronous checkpoint save (bilinear_tpu_torch/io/
checkpoint.py ``save_checkpoint(..., async_save=True)``,
``wait_for_async_saves``; counterpart of bilinear_tpu/io/checkpoint.py's)
and the size flags of ``cli/export_torch.py`` (``--n-stacks``,
``--features``, ``--depth``, as the JAX CLI takes them), on the CPU. The
trees are the ones the trainers hand over: numpy views of the model's own
tensors, which the optimizer updates in place."""
import collections
import os

import numpy as np
import pytest
import torch

from bilinear_tpu_torch.cli import export_torch
from bilinear_tpu_torch.io import checkpoint as ckpt
from bilinear_tpu_torch.models.bilinear import BilinearUnit
from bilinear_tpu_torch.models.detectors import make_model
from bilinear_tpu_torch.utils import weights as wt
from torch_port_fixtures import one_torch_thread


# a named tuple in an optimizer tree (pickled by reference to this module)
_Moments = collections.namedtuple("_Moments", "mu nu")


def _trees(model):
    """(params, batch_stats, optimizer) that share memory with ``model``:
    numpy views (``Tensor.numpy()``) of its parameters and buffers."""
    params = {k: {"kernel": p.detach().numpy()}
              for k, p in model.named_parameters()}
    stats = {k: v.numpy() for k, v in model.named_buffers()}
    opt = {"0": {}, "1": {"count": np.asarray(3, np.int32),
                          "mu": {k: p.detach().numpy().T
                                 for k, p in model.named_parameters()}}}
    return params, stats, opt


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def model():
    return BilinearUnit(generator=torch.Generator().manual_seed(0))


def test_the_trees_share_the_models_memory(model):
    """What makes the host copy necessary: the trees move with the
    parameters."""
    params, stats, _ = _trees(model)
    key = next(iter(params))
    before = np.array(params[key]["kernel"])
    buffers = {k: np.array(v) for k, v in stats.items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for v in model.buffers():
            v.add_(1)
    assert not np.array_equal(params[key]["kernel"], before)
    assert not any(np.array_equal(stats[k], v) for k, v in buffers.items())


def test_async_save_writes_the_synchronous_bytes(model, tmp_path):
    trees = _trees(model)
    sync = ckpt.save_checkpoint(str(tmp_path / "sync"), 4, *trees, step=9)
    path = ckpt.save_checkpoint(str(tmp_path / "async"), 4, *trees, step=9,
                                async_save=True)
    ckpt.wait_for_async_saves()
    assert path == str(tmp_path / "async" / "4.save")
    assert _read(path) == _read(sync)
    assert ckpt.load_checkpoint(str(tmp_path / "async"), 4)["step"] == 9


def test_changes_after_the_call_do_not_reach_the_file(model, tmp_path):
    trees = _trees(model)
    sync = ckpt.save_checkpoint(str(tmp_path / "sync"), 1, *trees)
    path = ckpt.save_checkpoint(str(tmp_path / "async"), 1, *trees,
                                async_save=True)
    with torch.no_grad():  # the next optimizer step, at once
        for p in model.parameters():
            p.mul_(-2.0)
        for v in model.buffers():
            v.add_(1)
    ckpt.wait_for_async_saves()
    assert _read(path) == _read(sync)


def test_tensor_leaves_are_copied_too(model, tmp_path):
    """A tree may hold the model's tensors themselves: a state_dict. Its
    OrderedDict, the tensors' dtype, device, layout and values come back
    as they were when the call returned (a pickled tensor carries its
    storage's address, so the check is by value, not by bytes)."""
    sd = model.state_dict()
    want = {k: v.clone() for k, v in sd.items()}
    ckpt.save_checkpoint(str(tmp_path), 1, sd, {}, async_save=True)
    with torch.no_grad():
        for v in sd.values():
            v.add_(1)
    ckpt.wait_for_async_saves()
    got = ckpt.load_checkpoint(str(tmp_path), 1)["state"]["params"]
    assert type(got) is collections.OrderedDict
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert (got[k].dtype, got[k].device, got[k].stride()) == \
            (v.dtype, v.device, v.stride())
        assert torch.equal(got[k], v)


def test_a_state_dict_tree_keeps_its_types_and_bytes(model, tmp_path):
    """An OrderedDict state_dict as numpy (with its ``_metadata``), a named
    tuple, a transposed view and one array met twice: the asynchronous
    save writes the synchronous save's bytes."""
    sd = model.state_dict()
    params = collections.OrderedDict((k, v.numpy()) for k, v in sd.items())
    params._metadata = sd._metadata
    first = next(iter(params.values()))
    opt = {"0": _Moments(mu=first, nu=first.T), "1": [first]}
    sync = ckpt.save_checkpoint(str(tmp_path / "sync"), 3, params, {}, opt)
    path = ckpt.save_checkpoint(str(tmp_path / "async"), 3, params, {}, opt,
                                async_save=True)
    with torch.no_grad():
        for v in sd.values():
            v.add_(1)
    ckpt.wait_for_async_saves()
    assert _read(path) == _read(sync)
    got = ckpt.load_checkpoint(str(tmp_path / "async"), 3)
    assert type(got["state"]["params"]) is collections.OrderedDict
    assert type(got["optimizer"]["0"]) is _Moments


def test_two_async_saves_in_a_row_are_both_whole(model, tmp_path):
    pdir = str(tmp_path / "parameter")
    first = _trees(model)
    want1 = _read(ckpt.save_checkpoint(str(tmp_path / "a"), 1, *first))
    ckpt.save_checkpoint(pdir, 1, *first, async_save=True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5)
    second = _trees(model)  # the same views, changed
    want2 = _read(ckpt.save_checkpoint(str(tmp_path / "b"), 2, *second))
    ckpt.save_checkpoint(pdir, 2, *second, async_save=True)
    ckpt.wait_for_async_saves()
    assert _read(os.path.join(pdir, "1.save")) == want1
    assert _read(os.path.join(pdir, "2.save")) == want2
    assert sorted(os.listdir(pdir)) == ["1.save", "2.save"]  # no tmp left
    assert ckpt.latest_epoch(pdir) == 2


def test_a_failed_async_save_raises_at_the_wait(model, tmp_path):
    pdir = tmp_path / "parameter"
    pdir.mkdir()
    (pdir / "3.save").mkdir()  # the rename onto a directory fails
    ckpt.save_checkpoint(str(pdir), 3, *_trees(model), async_save=True)
    with pytest.raises(OSError):
        ckpt.wait_for_async_saves()
    ckpt.wait_for_async_saves()  # reported once


def _hourglass_run(tmp_path):
    """A torch7 detector's checkpoint (2 stacks, 16 features, depth 2) under
    the Hourglass run dir, with an RMSprop state."""
    model = make_model("torch7", generator=torch.Generator().manual_seed(1),
                       n_stacks=2, features=16, depth=2)
    conv = wt.HOURGLASS["torch7"]
    params, stats = conv.to_jax(model.state_dict())
    square = {}
    for key, path, kind in conv.param_paths(
            conv.config_of_state_dict(model.state_dict())):
        wt.put_leaf(square, path, wt.leaf_to_jax(
            torch.zeros_like(dict(model.named_parameters())[key]), kind))
    opt = {"0": {}, "1": {"count": np.asarray(2, np.int32),
                          "square_avg": square}}
    ckpt.save_checkpoint(str(tmp_path / "save" / "Hourglass" / "parameter"),
                         2, params, stats, opt, step=6)
    return ["--family", "hourglass", "--save-root", str(tmp_path / "save")]


@pytest.mark.parametrize("flags", [
    [], ["--n-stacks", "2"], ["--n-stacks", "2", "--features", "16",
                              "--depth", "2"]])
def test_export_accepts_matching_sizes(tmp_path, flags):
    argv = _hourglass_run(tmp_path)
    export_torch.main(argv + flags)
    out = tmp_path / "save" / "Hourglass" / "torch_export" / "2.save"
    assert torch.load(str(out), weights_only=False)["step"] == 6


@pytest.mark.parametrize("flag, value, name, have", [
    ("--n-stacks", "8", "n_stacks", 2), ("--features", "256", "features", 16),
    ("--depth", "4", "depth", 2)])
def test_export_stops_on_a_size_that_disagrees(tmp_path, flag, value, name,
                                               have):
    argv = _hourglass_run(tmp_path)
    with pytest.raises(SystemExit, match=f"{flag} {value} disagrees with "
                                         f"the checkpoint's {name} {have}"):
        export_torch.main(argv + [flag, value])
    assert not (tmp_path / "save" / "Hourglass" / "torch_export").exists()


def test_export_refuses_sizes_for_the_lifting_mlp(tmp_path, model):
    ckpt.save_checkpoint(str(tmp_path / "save" / "Bilinear GT" /
                             "parameter"), 1, *_trees(model))
    with pytest.raises(SystemExit, match="bilinear family"):
        export_torch.main(["--family", "bilinear", "--save-root",
                           str(tmp_path / "save"), "--depth", "4"])
