"""The one traffic generator: it reads a mix's parameters (a file of
port_bench/traffic/) and the run's seed, and makes the inputs.

Pixels are drawn on the card (torch.Generator) and copied to the host
once; sizes and gt geometry come from numpy's generator of the seed.  So
that the seed changes which input gets what and not how much work there
is, the sizes (image extents, gt counts) are a fixed table spread over
the mix's ranges, dealt out in the seed's order.
"""

from __future__ import annotations

import numpy as np
import torch


def serve_images(mix: dict, seed: int, device) -> tuple[list, list]:
    """(warm-up images, pool images): uint8 BGR (H, W, 3) numpy arrays,
    the warm-up batch disjoint from the pool."""
    h, w = mix["image_hw"]
    n_warm, n_pool = mix["batch"], mix["pool_images"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    px = torch.randint(0, 256, (n_warm + n_pool, h, w, 3), generator=gen,
                       dtype=torch.uint8, device=device).cpu().numpy()
    imgs = list(px)
    return imgs[:n_warm], imgs[n_warm:]


def serve_batch(mix: dict, pool: list, i: int) -> list:
    """The i-th batch of the window: the pool taken in turn."""
    b = mix["batch"]
    lo = (i * b) % len(pool)
    return pool[lo:lo + b]


def rotated_rects(rng, n: int, h: int, w: int, mix: dict) -> np.ndarray:
    """n rotated rectangles centred inside an h x w image: long side and
    aspect uniform in the mix's ranges, any angle -> (n, 8) corners."""
    long = rng.uniform(*mix["long_side"], n)
    short = long / rng.uniform(*mix["aspect"], n)
    c = rng.uniform(0, 1, (n, 2)) * [w, h]
    ang = rng.uniform(0, np.pi, n)
    lx = np.array([-0.5, 0.5, 0.5, -0.5]) * long[:, None]
    ly = np.array([-0.5, -0.5, 0.5, 0.5]) * short[:, None]
    cs, sn = np.cos(ang)[:, None], np.sin(ang)[:, None]
    return np.stack([cs * lx - sn * ly + c[:, :1],
                     sn * lx + cs * ly + c[:, 1:]], -1).reshape(n, 8)


def train_batches(mix: dict, seed: int, max_gt: int, device) -> list[dict]:
    """pool_batches collated batches (data/loader.py's layout, numpy):
    images (B, S, S, 3) uint8 with noise inside each image's extent and 0
    beyond, gt_polys (B, max_gt, 8), gt_labels (B, max_gt) in 1..classes,
    gt_valid (B, max_gt), img_hw (B, 2)."""
    b, s, nb = mix["batch"], mix["canvas"], mix["pool_batches"]
    n = b * nb
    rng = np.random.default_rng(seed)
    lo, hi = mix["extent"]
    extents = np.rint(np.linspace(lo, hi, n)).astype(np.int64)
    g_lo, g_hi = mix["gts"]
    counts = np.rint(g_lo * (g_hi / g_lo) ** (np.arange(n) / (n - 1)))
    extents = extents[rng.permutation(n)]
    counts = counts[rng.permutation(n)].astype(np.int64)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for k in range(nb):
        px = torch.randint(0, 256, (b, s, s, 3), generator=gen,
                           dtype=torch.uint8, device=device)
        ext = torch.as_tensor(extents[k * b:(k + 1) * b], device=device)
        ar = torch.arange(s, device=device)
        inside = (ar[None, :, None] < ext[:, None, None]) & \
            (ar[None, None, :] < ext[:, None, None])
        images = (px * inside[..., None]).cpu().numpy()
        polys = np.zeros((b, max_gt, 8), np.float32)
        labels = np.zeros((b, max_gt), np.int32)
        valid = np.zeros((b, max_gt), bool)
        hw = np.zeros((b, 2), np.int32)
        for i in range(b):
            e, g = int(extents[k * b + i]), int(counts[k * b + i])
            polys[i, :g] = rotated_rects(rng, g, e, e, mix)
            labels[i, :g] = rng.integers(1, mix["classes"] + 1, g)
            valid[i, :g] = True
            hw[i] = (e, e)
        out.append(dict(images=images, gt_polys=polys, gt_labels=labels,
                        gt_valid=valid, img_hw=hw))
    return out
