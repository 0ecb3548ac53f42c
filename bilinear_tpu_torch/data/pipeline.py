"""Host-side image pipeline: decode -> region pre-crop -> static canvas (the
port's copy of ``bilinear_tpu/data/pipeline.py``).

- Host (this module): JPEG decode and a uint8 region pre-crop onto a
  fixed-size canvas, downscaling with PIL BILINEAR only when the
  (augmented, rotated) crop region cannot fit. Annotation coordinates are
  remapped into canvas space. The region copy is the native packer's
  (``native/fastpack.cpp``, built at first use); ``pack_region_np`` is its
  plain numpy version, the same arithmetic.
- Device: everything geometric and photometric (crop + rotate, flip, colour
  jitter, heatmaps) runs batched in ``train/hourglass.py::preprocess_batch``.

A thread prefetcher overlaps decode with device work. ``cache_dir``
decodes every record once into an on-disk uint8 canvas memmap plus an
``.npz`` of the canvas-space annotations, in the JAX package's layout
(``canvas{C}_n{n}_v2.u8`` / ``.npz``), so either package reads a cache the
other wrote.
"""
from __future__ import annotations

import math
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image

from bilinear_tpu_torch import native
from bilinear_tpu_torch.data.mpii import MPIIAnnotations, MPIIRecord

# Margin covering scale jitter (x2^0.5) and rotation (x sqrt(2)) around the
# 200*scale crop box.
REGION_MARGIN = 2.05


@dataclass
class CanvasBatch:
    """Device-ready host arrays, all canvas-space."""

    images: np.ndarray  # (B, C, C, 3); float32 in [0,1], or uint8 when the
    # pipeline uses transport='u8' (crop_batch rescales on device)
    centers: np.ndarray  # (B, 2)
    scales: np.ndarray  # (B,)
    keypoints: np.ndarray  # (B, 16, 2), NaN where unannotated
    valid: np.ndarray  # (B, 16) bool
    heads: np.ndarray  # (B,)
    index: np.ndarray  # (B,) dataset indices (for eval bookkeeping)
    pad: int  # number of zero-padded tail entries


def record_to_canvas(
    image: Image.Image, record: MPIIRecord, canvas: int, as_u8: bool = False
) -> tuple[np.ndarray, np.ndarray, float, np.ndarray, float]:
    """Pre-crop the needed region onto a (canvas, canvas) array; return
    (canvas_img, new_center, new_scale, new_keypoints, new_head). ``as_u8``
    keeps the canvas uint8 (the wire format of the u8 transport path — [0,1]
    scaling then happens on device inside crop_batch); default is float32 in
    [0,1], value-identical after that device scaling."""
    center = record.center.astype(np.float64).copy()
    scale = float(record.scale)
    keypoints = record.keypoints.astype(np.float64).copy()
    head = float(record.head)

    half = 100.0 * scale * REGION_MARGIN
    if 2 * half > canvas:
        f = (2 * half) / canvas
        new_w = max(2, math.floor(image.width / f))
        new_h = max(2, math.floor(image.height / f))
        image = image.resize((new_w, new_h), Image.BILINEAR)
        center /= f
        scale /= f
        keypoints /= f
        # PCKh distances are computed in canvas space (eval/pckh.py), so the
        # head length must shrink with every other annotation — leaving it in
        # original-image units inflates PCKh by f for downscaled records.
        head /= f
        half /= f

    ul = np.floor(center - half).astype(np.int64)
    src_u8 = np.asarray(image, np.uint8)
    if src_u8.ndim == 2:
        src_u8 = np.stack([src_u8] * 3, axis=-1)

    pack = native.pack_canvas_u8 if as_u8 else native.pack_canvas_f32
    region = pack(src_u8, canvas, int(ul[0]), int(ul[1]))

    offset = ul.astype(np.float64)
    return region, (center - offset).astype(np.float32), float(scale), (
        keypoints - offset
    ).astype(np.float32), head


def pack_region_np(src_u8: np.ndarray, canvas: int, ul_x: int, ul_y: int,
                   as_u8: bool = False) -> np.ndarray:
    """The native packer's plain numpy version: the (canvas, canvas, 3)
    region of ``src_u8`` starting at (ul_x, ul_y), zero outside the source;
    uint8, or float32 as x * (1 / 255) in float32 (the packer's
    arithmetic)."""
    dt = np.uint8 if as_u8 else np.float32
    region = np.zeros((canvas, canvas, src_u8.shape[2]), dt)
    src = src_u8 if as_u8 else \
        src_u8.astype(np.float32) * (np.float32(1.0) / np.float32(255.0))
    h, w = src_u8.shape[:2]
    sy0, sx0 = max(0, ul_y), max(0, ul_x)
    sy1, sx1 = min(h, ul_y + canvas), min(w, ul_x + canvas)
    dy0, dx0 = sy0 - ul_y, sx0 - ul_x
    if sy1 > sy0 and sx1 > sx0:
        region[dy0 : dy0 + (sy1 - sy0), dx0 : dx0 + (sx1 - sx0)] = src[
            sy0:sy1, sx0:sx1
        ]
    return region


class MPIIHostPipeline:
    """Batched, optionally-prefetched canvas batches over an MPII subset."""

    def __init__(
        self,
        annotations: MPIIAnnotations,
        batch_size: int,
        canvas: int = 512,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        pad: bool = False,
        transport: str = "f32",  # 'u8' ships uint8 canvases (4x less
        # host->device traffic; device rescales to [0,1] in crop_batch)
        cache_dir: Optional[str] = None,  # materialize decoded u8 canvases
        # to a memmap on first use; later epochs skip JPEG decode entirely.
        # Augmentation is on the card, so cached canvases stay augmented
        # per epoch. Requires transport='u8'. C*C*3 bytes per record.
    ):
        assert transport in ("f32", "u8"), transport
        if cache_dir is not None and transport != "u8":
            raise ValueError("the canvas cache stores uint8; use "
                             "transport='u8'")
        self.annotations = annotations
        self.batch_size = batch_size
        self.canvas = canvas
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # pad=True zero-fills the final short batch to batch_size (static
        # shapes for jitted eval); pad=False emits it short (training keeps
        # the reference's drop_last=False semantics without fake samples).
        self.pad = pad
        # JPEG decode dominates host time and releases the GIL in PIL's C
        # core, so intra-batch samples load in parallel (replaces the
        # reference's 8 worker processes, without pickling).
        self.transport = transport
        self.cache_dir = cache_dir
        self._cache = None  # (images memmap, meta dict) once materialized
        self._pool: Optional[ThreadPoolExecutor] = None
        self.decode_threads = 8
        self.decoded = 0  # records decoded from their JPEG (tests, smoke)

    def _get_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.decode_threads)
        return self._pool

    def _decode(self, index: int, as_u8: bool):
        rec = self.annotations.record(index)
        with Image.open(self.annotations.image_path(rec)) as img:
            img = img.convert("RGB")
            out = record_to_canvas(img, rec, self.canvas, as_u8=as_u8)
        self.decoded += 1
        return rec, out

    # ------------------------------------------------------------- cache
    def materialize(self) -> None:
        """Decode every record once into an on-disk uint8 canvas memmap
        (plus an .npz of the canvas-space annotations); later epochs read
        slices of it. The JAX package's files: tag
        ``canvas{C}_n{n}_v2`` (v2: heads in canvas space), written under
        per-process temporary names and published with ``os.replace``, so
        two processes sharing a cache directory never see half a file."""
        if self._cache is not None or self.cache_dir is None:
            return
        os.makedirs(self.cache_dir, exist_ok=True)
        n = len(self.annotations)
        tag = f"canvas{self.canvas}_n{n}_v2"
        img_path = os.path.join(self.cache_dir, f"{tag}.u8")
        meta_path = os.path.join(self.cache_dir, f"{tag}.npz")
        shape = (n, self.canvas, self.canvas, 3)
        if not (os.path.exists(img_path) and os.path.exists(meta_path)):
            tmp_suffix = f".tmp.{os.getpid()}"
            mm = np.lib.format.open_memmap(
                img_path + tmp_suffix, mode="w+", dtype=np.uint8, shape=shape
            )
            centers = np.zeros((n, 2), np.float32)
            scales = np.ones(n, np.float32)
            keypoints = np.full((n, 16, 2), np.nan, np.float32)
            valid = np.zeros((n, 16), bool)
            heads = np.ones(n, np.float32)

            def load_one(index):
                rec, (region, c, s, kp, head) = self._decode(index, True)
                mm[index] = region
                centers[index] = c
                scales[index] = s
                keypoints[index] = kp
                valid[index] = rec.valid
                heads[index] = head

            list(self._get_pool().map(load_one, range(n)))
            mm.flush()
            del mm
            np.savez(
                meta_path + tmp_suffix + ".npz", centers=centers,
                scales=scales, keypoints=keypoints, valid=valid, heads=heads,
            )
            os.replace(meta_path + tmp_suffix + ".npz", meta_path)
            os.replace(img_path + tmp_suffix, img_path)
        images = np.load(img_path, mmap_mode="r")
        meta = dict(np.load(meta_path))
        self._cache = (images, meta)

    def _load_cached(self, indices: Sequence[int]) -> CanvasBatch:
        images_mm, meta = self._cache
        B = self.batch_size if self.pad else len(indices)
        idx = np.asarray(indices, np.int64)
        images = np.zeros((B, self.canvas, self.canvas, 3), np.uint8)
        images[: len(idx)] = images_mm[idx]

        def take(key, fill, dtype):
            out = np.full((B,) + meta[key].shape[1:], fill, dtype)
            out[: len(idx)] = meta[key][idx]
            return out

        return CanvasBatch(
            images,
            take("centers", 0.0, np.float32),
            take("scales", 1.0, np.float32),
            take("keypoints", np.nan, np.float32),
            take("valid", False, bool),
            take("heads", 1.0, np.float32),
            np.concatenate([idx, np.full(B - len(idx), -1, np.int64)]),
            pad=B - len(idx),
        )

    def __len__(self) -> int:
        n = len(self.annotations)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load(self, indices: Sequence[int]) -> CanvasBatch:
        if self.cache_dir is not None:
            self.materialize()
            return self._load_cached(indices)
        B = self.batch_size if self.pad else len(indices)
        u8 = self.transport == "u8"
        images = np.zeros(
            (B, self.canvas, self.canvas, 3), np.uint8 if u8 else np.float32
        )
        centers = np.zeros((B, 2), np.float32)
        scales = np.ones(B, np.float32)
        keypoints = np.full((B, 16, 2), np.nan, np.float32)
        valid = np.zeros((B, 16), bool)
        heads = np.ones(B, np.float32)
        idx_arr = np.full(B, -1, np.int64)

        def load_one(slot_index):
            slot, index = slot_index
            rec, (region, c, s, kp, head) = self._decode(index, u8)
            images[slot] = region
            centers[slot] = c
            scales[slot] = s
            keypoints[slot] = kp
            valid[slot] = rec.valid
            heads[slot] = head
            idx_arr[slot] = index

        list(self._get_pool().map(load_one, enumerate(indices)))
        return CanvasBatch(
            images, centers, scales, keypoints, valid, heads, idx_arr,
            pad=B - len(indices),
        )

    def _index_batches(self, epoch: int) -> List[List[int]]:
        n = len(self.annotations)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        batches = [
            list(order[i : i + self.batch_size])
            for i in range(0, n, self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[CanvasBatch]:
        return self.epoch(0)

    def epoch(self, epoch: int = 0, prefetch: int = 2) -> Iterator[CanvasBatch]:
        batches = self._index_batches(epoch)
        if prefetch <= 0:
            for b in batches:
                yield self._load(b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        sentinel = object()
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # Bounded put + stop flag: if the consumer abandons the
            # generator (recalibrate's max_batches break, exceptions in the
            # train loop), the thread must exit instead of blocking on the
            # full queue forever holding ~25 MB decoded batches. Applies to
            # the sentinel/error puts too — an abandoned epoch can leave the
            # queue full right as the worker finishes its last batch.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in batches:
                    if not put_or_stop(self._load(b)):
                        return
                put_or_stop(sentinel)
            except BaseException as e:  # surface loader errors to the consumer
                put_or_stop(e)

        t = threading.Thread(
            target=worker, daemon=True, name="pipeline-prefetch"
        )
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()  # runs on GeneratorExit too (early-abandoned epoch)
