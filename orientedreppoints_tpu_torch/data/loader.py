"""Batch loader (counterpart of data/loader.py): aspect-grouped sampling,
fixed-canvas padding, gt padding, and a prefetching thread.

Batches are padded onto a fixed canvas (the smallest of canvas_buckets
that fits) and their gts onto max_gt rows, so every step has the same
shapes.  The emitted dict is the layout parallel/train.py::BATCH_KEYS
takes: images (B, H, W, 3), uint8 when the pipeline normalizes on the
device (Normalize(device=True)) else float32; gt_polys (B, G, 8) float32;
gt_labels (B, G) int32; gt_valid (B, G) bool; img_hw (B, 2) int32, the
true (unpadded) sizes.

Everything here is host numpy; the worker thread touches no device
(parallel/train.to_device moves a batch).  The sampler's shuffles come
from RandomState(seed + epoch), as in the JAX loader; the pipeline's
random draws (RotateResize's scale, RotateRandomFlip, the hard-aug
transforms and a mosaic's extra tiles) from aug_rng(seed, epoch), a
RandomState the loader creates per epoch, where the JAX package draws
from the global np.random.  An epoch's batches
therefore depend only on (seed, epoch), and a resumed run draws what an
uninterrupted one would.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

PREFETCH = 2  # batches the worker thread may hold ready

class GroupedBatchSampler:
    """Shuffled batches keeping one aspect-ratio group per batch (mmdet
    GroupSampler semantics: a short group is padded with its own first
    indices)."""

    def __init__(self, flags: np.ndarray, batch_size: int, seed: int = 0):
        self.flags = np.asarray(flags)
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        batches = []
        for g in np.unique(self.flags):
            idxs = np.where(self.flags == g)[0]
            self.rng.shuffle(idxs)
            pad = (-len(idxs)) % self.batch_size
            if pad:
                idxs = np.concatenate([idxs, idxs[:pad]])
            batches.extend(idxs[i:i + self.batch_size]
                           for i in range(0, len(idxs), self.batch_size))
        for i in self.rng.permutation(len(batches)):
            yield batches[i]

    def __len__(self):
        return sum(-(-int((self.flags == g).sum()) // self.batch_size)
                   for g in np.unique(self.flags))


def aug_rng(seed: int, epoch: int) -> np.random.RandomState:
    """The pipeline's RandomState for one epoch."""
    return np.random.RandomState([seed, epoch])


def pick_canvas(h, w, buckets):
    """The first (h, w) bucket that holds the image, else the last."""
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    return buckets[-1]


def collate(samples: Sequence[dict], canvas: tuple[int, int], max_gt: int):
    """Paste each sample's image at the canvas origin (cropped if it
    overflows) and its first max_gt gts into fixed-size arrays."""
    b = len(samples)
    ch, cw = canvas
    img_dtype = (np.uint8 if all(s["img"].dtype == np.uint8 for s in samples)
                 else np.float32)
    images = np.zeros((b, ch, cw, 3), img_dtype)
    gt_polys = np.zeros((b, max_gt, 8), np.float32)
    gt_labels = np.zeros((b, max_gt), np.int32)
    gt_valid = np.zeros((b, max_gt), bool)
    img_hw = np.zeros((b, 2), np.int32)
    for i, s in enumerate(samples):
        img = s["img"][:ch, :cw]
        images[i, :img.shape[0], :img.shape[1]] = img
        img_hw[i] = s["img_shape"][:2]
        polys = s.get("gt_bboxes", np.zeros((0, 8), np.float32))
        labels = s.get("gt_labels", np.zeros((0,), np.int64))
        n = min(len(polys), max_gt)
        gt_polys[i, :n] = polys[:n]
        gt_labels[i, :n] = labels[:n]
        gt_valid[i, :n] = True
    return dict(images=images, gt_polys=gt_polys, gt_labels=gt_labels,
                gt_valid=gt_valid, img_hw=img_hw)


class DataLoader:
    """Prefetching loader over a dataset with a train pipeline.  Each
    iteration is one epoch; `epoch` counts the iterations begun (set it
    to resume)."""

    def __init__(self, dataset, batch_size: int,
                 canvas_buckets: Sequence[tuple[int, int]] = ((1344, 1344),),
                 max_gt: int = 512, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.canvas_buckets = [tuple(c) for c in canvas_buckets]
        self.max_gt = max_gt
        self.seed = seed
        self.epoch = 0

    def _iter_epoch(self, epoch: int) -> Iterator[dict]:
        sampler = GroupedBatchSampler(self.dataset.flag, self.batch_size,
                                      seed=self.seed + epoch)
        rng = aug_rng(self.seed, epoch)
        for batch_idx in sampler:
            samples = [s for s in (self.dataset.prepare(int(i), rng)
                                   for i in batch_idx) if s is not None]
            if not samples:
                continue
            canvas = pick_canvas(max(s["img"].shape[0] for s in samples),
                                 max(s["img"].shape[1] for s in samples),
                                 self.canvas_buckets)
            yield collate(samples, canvas, self.max_gt)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        end = object()
        errors: list[BaseException] = []
        epoch = self.epoch

        def put(item) -> bool:
            """Put, polling for the consumer's exit; False once it left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._iter_epoch(epoch):
                    if not put(b):
                        return
            except BaseException as e:  # re-raised in the consumer
                errors.append(e)
            finally:
                put(end)

        t = threading.Thread(target=worker, name="DataLoader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                yield item
        finally:
            # the consumer may leave mid-epoch (max_iters): unblock the
            # worker and join it, so that no thread outlives the epoch
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10.0)
            self.epoch = epoch + 1
        if errors:
            raise errors[0]

    def __len__(self):
        return len(GroupedBatchSampler(self.dataset.flag, self.batch_size))
