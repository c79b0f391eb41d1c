"""Batch loader (counterpart of data/loader.py): aspect-grouped sampling,
fixed-canvas padding, gt padding, and a prefetching thread.

Batches are padded onto a fixed canvas (the smallest of canvas_buckets
that fits) and their gts onto max_gt rows, so every step has the same
shapes.  The emitted dict is the layout parallel/train.py::BATCH_KEYS
takes: images (B, H, W, 3), uint8 when the pipeline normalizes on the
device (Normalize(device=True)) else float32; gt_polys (B, G, 8) float32;
gt_labels (B, G) int32; gt_valid (B, G) bool; img_hw (B, 2) int32, the
true (unpadded) sizes.

Everything here is host numpy; the worker thread prepares the samples,
the consumer collates them, and neither touches a device
(parallel/train.to_device moves a batch).  The sampler's shuffles come
from RandomState(seed + epoch), as in the JAX loader; the pipeline's
random draws (RotateResize's scale, RotateRandomFlip, the hard-aug
transforms and a mosaic's extra tiles) from aug_rng(seed, epoch), a
RandomState the loader creates per epoch, where the JAX package draws
from the global np.random.  An epoch's batches
therefore depend only on (seed, epoch), and a resumed run draws what an
uninterrupted one would.

Data-parallel (a gloo group over the W ranks, parallel/dist.cpu_group):
every rank runs the same sampler order over global batches of
batch_size, prepares and collates only its own batch_size / W of them (W
must divide batch_size), rank r the rows [r b, (r + 1) b), and all ranks
put their rows on one canvas, the bucket the global batch's largest image
needs (a MAX all-reduce of its height and width in the consumer's thread,
where it keeps its place among the step's collectives; the worker thread
prepares the samples).  The ranks' batches stacked in rank order
are the one-process batch of a pipeline without random steps.  A random
pipeline draws from RandomState([seed, epoch, rank]) at W > 1, so it
draws differently from one process.  When part of a rank's share drops
out (FilterEmpty), the ranks hold shares of different sizes, still the
one-process batch when stacked, and the step takes them
(parallel/train.make_train_step exchanges the counts).  A global batch
from which a rank's share drops out entirely is skipped on every rank,
where one process would step its other rows.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from ..parallel import dist

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


def aug_rng(seed: int, epoch: int,
            rank: int | None = None) -> np.random.RandomState:
    """The pipeline's RandomState for one epoch (and one rank of a group
    of more than one)."""
    return np.random.RandomState([seed, epoch] if rank is None
                                 else [seed, epoch, rank])


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
                 max_gt: int = 512, seed: int = 0, group=None):
        """batch_size: the global batch; group: a gloo group of the
        data-parallel ranks (module docstring), None for one process."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.canvas_buckets = [tuple(c) for c in canvas_buckets]
        self.max_gt = max_gt
        self.seed = seed
        self.epoch = 0
        self.group = group
        self.rank, self.world = dist.rank(group), dist.world_size(group)
        if batch_size % self.world:
            raise ValueError(f"DataLoader: {self.world} ranks do not split "
                             f"the global batch of {batch_size}")

    def _samples(self, epoch: int) -> Iterator[list]:
        """The prepared samples of this rank's rows of each global batch
        (the worker thread's part)."""
        sampler = GroupedBatchSampler(self.dataset.flag, self.batch_size,
                                      seed=self.seed + epoch)
        b = self.batch_size // self.world
        rows = slice(self.rank * b, (self.rank + 1) * b)
        rng = aug_rng(self.seed, epoch,
                      self.rank if self.world > 1 else None)
        for batch_idx in sampler:
            yield [s for s in (self.dataset.prepare(int(i), rng)
                               for i in batch_idx[rows]) if s is not None]

    def _collate(self, samples: list) -> dict | None:
        """The batch of one global batch's samples on the canvas its
        largest image needs; None when a rank has no sample.  The group's
        all-reduce runs here, in the consumer's thread, so that it keeps
        its place among the step's collectives on every rank."""
        # the largest image, and the least row count (MAX of the negated
        # counts): over the group when there is one
        t = dist.all_reduce_max(torch.tensor(
            [max((s["img"].shape[0] for s in samples), default=0),
             max((s["img"].shape[1] for s in samples), default=0),
             -len(samples)]), self.group)
        if int(t[2]) == 0:
            return None
        canvas = pick_canvas(int(t[0]), int(t[1]), self.canvas_buckets)
        return collate(samples, canvas, self.max_gt)

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
                for samples in self._samples(epoch):
                    if not put(samples):
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
                batch = self._collate(item)
                if batch is not None:
                    yield batch
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
