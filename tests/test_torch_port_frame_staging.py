"""``End2EndServer``'s frame staging (``serving.py::memory_order``,
``End2EndServer._stage``): frames of any layout a caller hands in are
staged in their own memory order and restored on the device, so ``predict``
answers as it does for the same frames made C-contiguous, bit for bit, and
``frames_reordered`` / ``frames_padded`` count what the staging did. On the
CPU at a small width; the tests marked ``cuda`` run on the card (``python
-m pytest tests/test_torch_port_frame_staging.py -m cuda --noconftest -q``)
and skip without one. The file imports no JAX."""
import sys
import threading

import numpy as np
import pytest
import torch

from bilinear_tpu_torch.models.end2end import End2End
from bilinear_tpu_torch.serving import End2EndServer, memory_order
from bilinear_tpu_torch.utils import weights as wt

SIZE = dict(n_stacks=1, features=16, depth=2)
SIZES = (2, 4)
FRAME = (256, 256, 3)


def _server(device: str, sizes=SIZES) -> End2EndServer:
    model = End2End(**SIZE, generator=torch.Generator().manual_seed(0))
    params, stats = wt.end2end_to_jax(model.state_dict(), "torch7")
    return End2EndServer(
        {"params": params, "batch_stats": stats}, np.zeros(32),
        np.ones(32), np.zeros(48), np.ones(48), dtype=torch.float32,
        batch_sizes=sizes, model_kw=dict(SIZE, fused=device == "cpu"),
        device=device)


@pytest.fixture(scope="module")
def server():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _server("cpu")
    finally:
        torch.set_num_threads(threads)


def _u8(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _pool_layout(x: np.ndarray) -> np.ndarray:
    """``x`` (n, h, w, c) laid out [channel][row][frame][column], as the
    benchmark's frame pool is."""
    return np.ascontiguousarray(x.transpose(3, 1, 0, 2)).transpose(
        2, 1, 3, 0)


def _pool(n: int, frames: int = 256) -> np.ndarray:
    """The [n:2n] slice of ``frames`` u8 frames in the pool's layout."""
    pool = _pool_layout(_u8((frames,) + FRAME, 1))
    assert pool.strides == (256, 256 * frames, 1, 256 * 256 * frames)
    return pool[n:2 * n]


# name -> (frames, expected memory_order, frames counted as reordered)
LAYOUTS = {
    "c_contiguous": lambda: (_u8((4,) + FRAME, 2), (0, 1, 2, 3), 0),
    "benchmark_pool": lambda: (_pool(4), (3, 1, 0, 2), 4),
    "crop": lambda: (_u8((4, 300, 320, 3), 3)[:, 10:266, 20:276],
                     (0, 1, 2, 3), 0),
    "bgr_flip": lambda: (_u8((4,) + FRAME, 4)[..., ::-1], (0, 1, 2, 3), 0),
    "nchw_transposed": lambda: (_u8((4, 3, 256, 256), 5).transpose(
        0, 2, 3, 1), (0, 3, 1, 2), 4),
    "video_every_second": lambda: (_u8((8,) + FRAME, 6)[::2], (0, 1, 2, 3),
                                   0),
    "broadcast_one_frame": lambda: (np.broadcast_to(
        _u8(FRAME, 7), (4,) + FRAME), (0, 1, 2, 3), 0),
    "f32_nchw_transposed": lambda: ((_u8((4, 3, 256, 256), 8) / np.float32(
        255)).transpose(0, 2, 3, 1), (0, 3, 1, 2), 4),
    "pool_three_chunks_padded": lambda: (_pool(7), (3, 1, 0, 2), 7),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_memory_order_of_each_layout(layout):
    frames, order, _ = LAYOUTS[layout]()
    assert memory_order(frames) == order
    if order != (0, 1, 2, 3):  # read in it, the innermost step is one item
        assert frames.transpose(order).strides[-1] == frames.itemsize


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_predict_equals_contiguous_predict(server, layout):
    """predict(x) == predict(np.ascontiguousarray(x)) bit for bit, 2D and
    3D; the counters move by the frames reordered and the padded frames."""
    frames, _, reordered = LAYOUTS[layout]()
    n = len(frames)
    chunks = server._chunks(n)
    padded = sum(batch - take for take, batch in chunks)
    assert (len(chunks), padded) == ((3, 1) if n == 7 else (1, 0))
    before = server.frames_reordered, server.frames_padded
    got = server.predict(frames)
    assert server.frames_reordered == before[0] + reordered
    assert server.frames_padded == before[1] + padded
    want = server.predict(np.ascontiguousarray(frames))
    assert server.frames_reordered == before[0] + reordered
    assert server.frames_padded == before[1] + 2 * padded
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_concurrent_predicts_keep_their_frames(server):
    """Six threads (more than the cores a worker gets) call predict at
    once on distinct strided frames under a short switch interval; each
    answer equals the same call made alone, and no count is lost."""
    frames = [_pool_layout(_u8((1,) + FRAME, 10 + k)) for k in range(6)]
    alone = [server.predict(f) for f in frames]
    before = server.frames_reordered
    got = [None] * len(frames)

    def call(k):
        got[k] = server.predict(frames[k])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(k,))
                   for k in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert server.frames_reordered == before + len(frames)
    for g, w in zip(got, alone):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return _server("cuda", sizes=(4,))


@pytest.mark.cuda
def test_three_chunks_equal_three_calls_on_the_card(card):
    """A 12-frame call (three chunks of 4 through the one pinned staging
    buffer, each rewritten once the copy of the one before has read it)
    answers as three 4-frame calls do, on distinct frames in the benchmark
    pool's layout."""
    frames = _pool(12, 64)
    whole = card.predict(frames)
    parts = [card.predict(frames[k:k + 4]) for k in (0, 4, 8)]
    assert card._staging.is_pinned()
    for i in range(2):
        np.testing.assert_array_equal(
            whole[i], np.concatenate([p[i] for p in parts]))


@pytest.mark.cuda
def test_staged_input_is_the_old_cast_bit_for_bit(card):
    """On the card the staged f32 input is ``frames.float() / 255`` of the
    C-contiguous frames, bit for bit; the padding frame is zero and its
    centre and scale 128 and 1."""
    frames = _pool(3, 64)
    centers = np.random.default_rng(9).uniform(100, 150, (3, 2)).astype(
        np.float32)
    scales = np.float32([1.1, 1.2, 1.3])
    f, c, s = card._stage(frames, centers, scales, 4)
    want = torch.from_numpy(np.ascontiguousarray(frames)).cuda().float() \
        / card._255
    assert f.is_contiguous() and f.shape == (4,) + FRAME
    assert torch.equal(f[:3], want) and not f[3].any()
    assert torch.equal(c.cpu(), torch.tensor(
        np.concatenate([centers, [[128.0, 128.0]]]), dtype=torch.float32))
    assert torch.equal(s.cpu(), torch.tensor([1.1, 1.2, 1.3, 1.0]))
