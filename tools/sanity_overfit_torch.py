#!/usr/bin/env python
"""Training sanity check: overfit a tiny synthetic oriented-box set and
score the detections on it (counterpart of tools/sanity_overfit.py).

    python3 tools/sanity_overfit_torch.py [--steps 300] [--img 256] \\
        [--batch 4] [--lr 0.005] [--backbone r18] [--device cuda]

The scenes are the JAX tool's: per image, uniform noise (x 0.3) with three
bright rotated rectangles filled by data/synth.fill_poly (cv2.fillPoly on a
float32 image, bit for bit), all from RandomState(0).  The detector (16
classes, bf16, the backbone family's defaults, seeded random weights)
takes --steps SGD steps (momentum 0.9, weight decay 1e-4, constant --lr,
max_pos 64) on that one batch, then decodes it (nms_pre 500, score_thr
0.3, iou_thr 0.4, max_per_img 20).  It passes, and exits 0, when the last
loss is below 0.7 x the first and recall@0.5 (a gt matched by a det of
polygon IoU > 0.5) is at least 0.5; else it prints SANITY FAIL and exits 1.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402

BACKBONES = {
    "r18": dict(depth=18),
    "r50": dict(depth=50),
    "r101": dict(depth=101),
    "hrnet": dict(backbone_type="hrnet"),
    "ssd_vgg": dict(backbone_type="ssd_vgg"),
    "swin": dict(backbone_type="swin"),
}


def scenes(img_size: int, batch: int):
    """-> (images (batch, S, S, 3) float32, [each image's (3, 8) gt polys
    float32]): the JAX tool's draws from RandomState(0), in its order."""
    from orientedreppoints_tpu_torch.data.synth import fill_poly

    rng = np.random.RandomState(0)
    gts, imgs = [], []
    for _ in range(batch):
        img = rng.rand(img_size, img_size, 3).astype(np.float32) * 0.3
        polys = []
        for j in range(3):
            cx, cy = rng.rand(2) * (img_size - 120) + 60
            w, h = rng.rand() * 40 + 30, rng.rand() * 20 + 12
            a = rng.rand() * np.pi
            c, s = np.cos(a), np.sin(a)
            r = (np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2],
                           [-w / 2, h / 2]]) @ [[c, s], [-s, c]]) + [cx, cy]
            polys.append(r.reshape(-1))
            fill_poly(img, np.round(r).astype(np.int32),
                      (1.5 + 0.5 * j, 2.0, 1.0))
        gts.append(np.array(polys, np.float32))
        imgs.append(img)
    return np.stack(imgs), gts


def train_batch(imgs, gts) -> dict:
    """The collated batch of the scenes: 8 gt slots an image, label 1."""
    b = len(gts)
    gt_polys = np.zeros((b, 8, 8), np.float32)
    gt_labels = np.zeros((b, 8), np.int32)
    gt_valid = np.zeros((b, 8), bool)
    for i, g in enumerate(gts):
        gt_polys[i, :len(g)] = g
        gt_labels[i, :len(g)] = 1
        gt_valid[i, :len(g)] = True
    return dict(images=imgs, gt_polys=gt_polys, gt_labels=gt_labels,
                gt_valid=gt_valid,
                img_hw=np.full((b, 2), imgs.shape[1], np.int32))


def overfit(steps: int = 300, img: int = 256, batch: int = 4,
            lr: float = 0.005, backbone: str = "r18", device="cuda",
            log=print) -> dict:
    """Train and score as the module docstring says -> dict(first, final,
    recall, matched, total, ok, train_s)."""
    import torch

    from orientedreppoints_tpu_torch.apis import resolve_device
    from orientedreppoints_tpu_torch.core.loss_head import LossConfig
    from orientedreppoints_tpu_torch.devkit.polygon import poly_iou
    from orientedreppoints_tpu_torch.models.detector import (
        OrientedRepPointsDetector, decode_detections)
    from orientedreppoints_tpu_torch.parallel.train import (build_optimizer,
                                                            make_train_step,
                                                            to_device)

    device = resolve_device(device)
    imgs, gts = scenes(img, batch)
    data = to_device(train_batch(imgs, gts), device)
    model = OrientedRepPointsDetector(num_classes=16, dtype=torch.bfloat16,
                                      **BACKBONES[backbone])
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device)
    optimizer, scheduler = build_optimizer(model, lambda s: lr)
    step = make_train_step(model, LossConfig(max_pos=64), optimizer,
                           scheduler)
    t0 = time.perf_counter()
    first = None
    for it in range(steps):
        losses = step(data)
        if it % 50 == 0 or it == steps - 1:
            lt = float(losses["loss_total"])
            if first is None:
                first = lt
            log(f"step {it}: loss {lt:.4f} num_pos "
                f"{float(losses['num_pos']):.0f} "
                f"({time.perf_counter() - t0:.0f}s)")
    final = float(losses["loss_total"])
    train_s = time.perf_counter() - t0

    model.eval()
    with torch.inference_mode():
        dets, _, valid = decode_detections(
            model(data["images"]), nms_pre=500, score_thr=0.3, iou_thr=0.4,
            max_per_img=20)
    dets, valid = dets.float().cpu().numpy(), valid.cpu().numpy()
    matched = total = 0
    for i in range(batch):
        for g in gts[i]:
            total += 1
            best = 0.0
            for d in dets[i][valid[i]]:
                best = max(best, poly_iou(g, d[-9:-1]))
            matched += best > 0.5
    recall = matched / max(total, 1)
    log(f"loss {first:.3f} -> {final:.3f}; overfit recall@0.5 = "
        f"{matched}/{total} = {recall:.2f}")
    ok = final < first * 0.7 and recall >= 0.5
    log("SANITY " + ("PASS" if ok else "FAIL"))
    return dict(first=first, final=final, recall=recall, matched=matched,
                total=total, ok=ok, train_s=train_s)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--img", type=int, default=256)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--backbone", default="r18", choices=list(BACKBONES),
                   help="backbone family to overfit")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    res = overfit(args.steps, args.img, args.batch, args.lr, args.backbone,
                  args.device)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
