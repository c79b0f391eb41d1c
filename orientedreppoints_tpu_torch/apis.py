"""High-level APIs (counterpart of apis.py and utils/builder.py):

  * init_detector: config -> model -> optional weights;
  * build_dataset: a data config -> DotaDataset with its pipeline, and
    build_dataloader: the training loader from the config;
  * run_inference and run_inference_tta (multi-scale x flip test-time
    augmentation) over a dataset, on the model's device, or sharded over
    every visible card (parallel/infer.py);
  * evaluate_results: in-memory tile-level oriented mAP;
  * parse_tta_spec: the CLI's TTA flags -> aug list;
  * the training config readers build_loss_config / build_img_norm,
    build_trainer: the config's SGD or AdamW recipe and step on a model,
    one process or one rank of a data-parallel group, and
    train_epochs: the training loop with its checkpoints.
"""

from __future__ import annotations

import json
import os.path as osp
import time
from typing import Callable, Sequence

import numpy as np
import torch

from .core.loss_head import LossConfig
from .data.dota import DotaDataset, HrscDataset
from .data.loader import DataLoader
from .data.pipelines import build_pipeline
from .devkit.evaluation import _hbb_iou_prefilter, voc_ap
from .devkit.native import poly_iou_pairs
from .host import ceil32, load_config, rbbox2result, resize_linear
from .models.detector import (OrientedRepPointsDetector, decode_detections,
                              decode_no_nms, merge_aug_and_nms)
from .parallel import dist, train
from .parallel.infer import data_devices, round_up_batch, shard_infer
from .utils import checkpoint

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device) -> torch.device:
    """The device asked for; a CUDA device without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


# utils/builder.py's backbone types (JAX package) and the kwargs it passes
BACKBONES = {"ResNet": "resnet", "ResNeXt": "resnet",
             "SwinTransformer": "swin", "HRNet": "hrnet", "SSDVGG": "ssd_vgg"}
BACKBONE_KWARGS = {
    "resnet": ("groups", "base_width", "out_indices"),
    "swin": ("embed_dim", "depths", "num_heads", "window_size",
             "out_indices", "drop_path_rate"),
    "hrnet": ("extra",),
    "ssd_vgg": ("input_size", "depth", "l2_norm_scale"),
}


def build_detector(cfg, compute_dtype: str = "bfloat16"):
    """The config's detector with the backbone kwargs JAX's build_detector
    passes (lists as tuples), the neck's start_level / add_extra_convs when
    given (else the backbone's default wiring); an unknown backbone type
    raises."""
    m = cfg["model"]
    bb = m["backbone"]
    if bb["type"] not in BACKBONES:
        raise NotImplementedError(f"backbone {bb['type']} is not ported")
    bb_type = BACKBONES[bb["type"]]
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in bb.items() if k in BACKBONE_KWARGS[bb_type]}
    neck = m["neck"]
    head = m["bbox_head"]
    return OrientedRepPointsDetector(
        backbone_type=bb_type, depth=bb.get("depth", 50),
        num_classes=head["num_classes"],
        fpn_out_channels=neck["out_channels"], num_levels=neck["num_outs"],
        fpn_start_level=neck.get("start_level"),
        fpn_add_extra_convs=neck.get("add_extra_convs"),
        dtype=DTYPES[compute_dtype], backbone_kwargs=kwargs or None,
        head_kwargs={k: head[k] for k in (
            "feat_channels", "point_feat_channels", "stacked_convs",
            "num_points", "gradient_mul") if k in head})


def init_detector(config, state_dict: dict | None = None,
                  compute_dtype: str = "bfloat16", device="cuda",
                  seed: int = 0):
    """Build a detector from a config path or dict and put it on `device`.

    Without a state_dict the weights are random, drawn from a
    torch.Generator seeded with `seed`; with one, it is loaded strictly.
    Returns (model in eval mode, cfg).
    """
    device = resolve_device(device)
    cfg = load_config(config) if isinstance(config, str) else config
    model = build_detector(cfg, compute_dtype)
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval(), cfg


def build_dataset(dcfg, device_normalize: bool = False) -> DotaDataset:
    """A data config (type DotaDataset or HrscDataset, ann_file,
    img_prefix, pipeline, test_mode) -> the dataset with its pipeline
    built.  device_normalize (pass build_img_norm(cfg) is not None) sets
    Normalize(device=True), so the uint8 image reaches the train step,
    which normalizes on the card."""
    types = {"DotaDataset": DotaDataset, "HrscDataset": HrscDataset}
    if dcfg["type"] not in types:
        raise NotImplementedError(f"dataset {dcfg['type']} is not ported")
    steps = dcfg["pipeline"]
    if device_normalize:
        steps = [dict(s, device=True) if s.get("type") == "Normalize" else s
                 for s in steps]
    return types[dcfg["type"]](ann_file=dcfg["ann_file"],
                               img_prefix=dcfg.get("img_prefix", ""),
                               pipeline=build_pipeline(steps),
                               test_mode=dcfg.get("test_mode", False))


def build_dataloader(dataset, cfg, batch_size: int | None = None,
                     seed: int = 0, group=None) -> DataLoader:
    """The training loader from the config's `tpu` section:
    global_batch_size (default 8), canvas_buckets and max_gt; seed fixes
    the sampler's shuffles and the pipeline's draws of every epoch.  With
    a data-parallel group each rank loads its share of every global batch
    (data/loader.py), over a gloo group of the same ranks."""
    tpu = cfg.get("tpu", {})
    return DataLoader(dataset,
                      batch_size=batch_size or tpu.get("global_batch_size", 8),
                      canvas_buckets=tpu.get("canvas_buckets", [(1344, 1344)]),
                      max_gt=tpu.get("max_gt", 512), seed=seed,
                      group=dist.cpu_group(group))


def _batches(dataset, n: int, batch_size: int, canvas, device):
    """Yield (canvases (batch_size, H, W, 3) float32 on device, scale
    factors [batch_size], names) per batch; short batches are padded with
    zero canvases, factor 1.0 and name None.  Items are dicts with 'img'
    (normalized HWC float32), 'scale_factor' and 'img_info.file_name'."""
    for lo in range(0, n, batch_size):
        imgs = torch.zeros((batch_size,) + tuple(canvas) + (3,),
                           dtype=torch.float32, device=device)
        sfs, names = [], []
        for bi, i in enumerate(range(lo, min(lo + batch_size, n))):
            s = dataset[i]
            img = torch.as_tensor(np.asarray(s["img"], np.float32))
            imgs[bi, :img.shape[0], :img.shape[1]] = img.to(device)
            sfs.append(float(np.asarray(s.get("scale_factor", 1.0))
                             .reshape(-1)[0]))
            names.append(osp.splitext(s["img_info"]["file_name"])[0])
        sfs += [1.0] * (batch_size - len(sfs))
        names += [None] * (batch_size - len(names))
        yield imgs, sfs, names


def _collect(results, dets, labels, valid, names, num_fg):
    dets, labels, valid = (t.cpu().numpy() for t in (dets, labels, valid))
    for bi, name in enumerate(names):
        if name is not None:
            keep = valid[bi]
            results[name] = rbbox2result(dets[bi][keep][:, -9:],
                                         labels[bi][keep], num_fg + 1)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def infer_devices(devices, device: torch.device):
    """The devices a batch shards over: "all" (the entry points'
    default) is every visible card when `device` is a CUDA one
    (parallel/infer.data_devices: None below two), else None; a list is
    taken as it is; None: one device."""
    if isinstance(devices, str) and devices == "all":
        return data_devices() if device.type == "cuda" else None
    return devices


def detect_core(test_cfg):
    """fn(model, canvases, scale factors (B, 1, 1)) -> decode_detections'
    (dets, labels, valid): the model and the decode with test_cfg."""
    def core(model, imgs, sf):
        return decode_detections(
            model(imgs), nms_pre=test_cfg["nms_pre"],
            score_thr=test_cfg["score_thr"],
            iou_thr=test_cfg["nms"]["iou_thr"],
            max_per_img=test_cfg["max_per_img"],
            pre_nms_cap=test_cfg.get("pre_nms_cap", 4096), scale_factor=sf)
    return core


@torch.inference_mode()
def run_inference(model, dataset, test_cfg, canvas=(1344, 1344),
                  batch_size: int = 4, max_images: int | None = None,
                  num_fg: int = 15, devices="all"):
    """Inference over a dataset on the model's device -> {image_name:
    [per-class (k, 9) arrays]}.  Each image is pasted on a zero canvas,
    batches go through the model and decode_detections.

    devices: "all" shards each batch over every visible card when the
    model is on one and the host has two or more (JAX's data_mesh()), a
    list of devices over those, None on the model's device alone; the
    batch is rounded up to a multiple of their count."""
    device = _device(model)
    devices = infer_devices(devices, device)
    batch_size = round_up_batch(batch_size, devices)
    infer = shard_infer(detect_core(test_cfg), model, devices)
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    results = {}
    for imgs, sfs, names in _batches(dataset, n, batch_size, canvas, device):
        sf = torch.tensor(sfs, dtype=torch.float32, device=device)
        _collect(results, *infer(imgs, sf[:, None, None]), names, num_fg)
    return results


@torch.inference_mode()
def run_inference_tta(model, dataset, test_cfg, tta_augs: Sequence[tuple],
                      canvas=(1344, 1344), batch_size: int = 2,
                      max_images: int | None = None, num_fg: int = 15,
                      devices="all"):
    """Multi-scale / flip TTA inference on the model's device ->
    {image_name: [per-class (k, 9) arrays]}.

    tta_augs: (relative_scale, flip) pairs, e.g. [(0.5, False),
    (0.5, True), (1.0, False), ...].  Each scale r runs on its own canvas
    of ceil32(r * canvas), holding the normalized canvas resized to
    round(r * canvas) (resize_linear: cv2's INTER_LINEAR), and its flip
    variants share it (flip: the canvas mirrored left to right).  Every aug
    is decoded without NMS (decode_no_nms); per image, merge_aug_and_nms
    unflips each aug in its canvas frame, undoes its scale (image scale
    factor x r) and runs one multiclass_rnms over all augs' candidates.
    The (1.0, False) aug runs on exactly run_inference's canvas, so that
    recipe alone gives run_inference's detections.

    devices: as run_inference's; each replica runs this whole program
    (every scale's forward + decode, then the per-image merge) on its
    shard of the batch, as the JAX package's sharded scale and merge
    programs do.
    """
    device = _device(model)
    devices = infer_devices(devices, device)
    batch_size = round_up_batch(batch_size, devices)
    ch, cw = tuple(canvas)
    scales = list(dict.fromkeys(r for r, _ in tta_augs))
    scale_canvas = {r: (ceil32(ch * r), ceil32(cw * r)) for r in scales}
    aug_shapes = [scale_canvas[r] for r, _ in tta_augs]
    tc = test_cfg

    def core(m, sf_augs, *canvases):
        """Scale factors (B, A) and each scale's canvases -> every aug
        decoded, then per image merged -> (dets, labels, valid)."""
        aug = [None] * len(tta_augs)
        for r, x in zip(scales, canvases):
            for ai, (rr, flip) in enumerate(tta_augs):
                if rr == r:
                    aug[ai] = decode_no_nms(m(x.flip(2) if flip else x),
                                            nms_pre=tc["nms_pre"])
        outs = [merge_aug_and_nms(
            [b[bi] for b, _ in aug], [s[bi] for _, s in aug],
            [f for _, f in tta_augs], aug_shapes, list(sf_augs[bi]),
            score_thr=tc["score_thr"], iou_thr=tc["nms"]["iou_thr"],
            max_per_img=tc["max_per_img"],
            pre_nms_cap=tc.get("pre_nms_cap", 4096))
            for bi in range(sf_augs.shape[0])]
        return tuple(torch.stack(t) for t in zip(*outs))

    infer = shard_infer(core, model, devices)
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    results = {}
    for imgs, sfs, names in _batches(dataset, n, batch_size, canvas, device):
        canvases = []
        for r in scales:
            sh, sw = scale_canvas[r]
            x = torch.zeros((batch_size, sh, sw, 3), dtype=torch.float32,
                            device=device)
            rh, rw = (ch, cw) if r == 1.0 else (int(round(ch * r)),
                                                int(round(cw * r)))
            x[:, :rh, :rw] = resize_linear(imgs, (rh, rw))
            canvases.append(x)
        sf_augs = torch.tensor([[np.float32(sf * r) for r, _ in tta_augs]
                                for sf in sfs], dtype=torch.float32,
                               device=device)
        _collect(results, *infer(sf_augs, *canvases), names, num_fg)
    return results


def parse_tta_spec(ms_tta: str | None, flip_tta: bool):
    """CLI TTA flags -> [(relative_scale, flip)] aug list or None: every
    scale, optionally x both orientations (MultiScaleFlipAug)."""
    if ms_tta:
        scales = [float(s) for s in ms_tta.split(",")]
        flips = (False, True) if flip_tta else (False,)
        return [(r, f) for r in scales for f in flips]
    if flip_tta:
        return [(1.0, False), (1.0, True)]
    return None


def build_loss_config(cfg) -> LossConfig:
    """The head's loss settings and the two assigners' from a config dict;
    max_pos from its `tpu` section (default 1024)."""
    head = cfg["model"]["bbox_head"]
    init_as = cfg["train_cfg"]["init"]["assigner"]
    ref_as = cfg["train_cfg"]["refine"]["assigner"]
    return LossConfig(
        strides=tuple(head["point_strides"]),
        point_base_scale=float(head["point_base_scale"]),
        num_points=head["num_points"],
        max_pos=cfg.get("tpu", {}).get("max_pos", 1024),
        top_ratio=head.get("top_ratio", 0.4),
        init_assign_scale=float(init_as["scale"]),
        init_assign_pos_num=init_as["pos_num"],
        pos_iou_thr=ref_as["pos_iou_thr"],
        neg_iou_thr=ref_as["neg_iou_thr"],
        min_pos_iou=ref_as["min_pos_iou"],
        focal_gamma=head["loss_cls"]["gamma"],
        focal_alpha=head["loss_cls"]["alpha"],
        loss_cls_weight=head["loss_cls"]["loss_weight"],
        loss_rbox_init_weight=head["loss_rbox_init"]["loss_weight"],
        loss_rbox_refine_weight=head["loss_rbox_refine"]["loss_weight"],
        loss_spatial_init_weight=head["loss_spatial_init"]["loss_weight"],
        loss_spatial_refine_weight=head["loss_spatial_refine"]["loss_weight"],
    )


def build_img_norm(cfg):
    """The train pipeline's Normalize constants as device_normalize kwargs
    when cfg.tpu.device_normalize is set, else None."""
    if not cfg.get("tpu", {}).get("device_normalize", False):
        return None
    for step in cfg["data"]["train"]["pipeline"]:
        if step.get("type") == "Normalize":
            return dict(mean=tuple(float(m) for m in step["mean"]),
                        std=tuple(float(s) for s in step["std"]),
                        to_rgb=bool(step.get("to_rgb", True)))
    return None


def build_trainer(model, cfg, iters_per_epoch: int = 1000, seed: int = 0,
                  group=None):
    """The config's training recipe on `model` (on its device): the
    backbone's frozen_stages frozen (ResNet's stem and layers; Swin,
    HRNet and SSD-VGG have neither, so nothing, as in JAX), SGD with
    momentum and weight decay or AdamW with the no-decay substrings,
    under lr_config's warmup + step schedule counted in iterations
    (iters_per_epoch of them an epoch), the global-norm clip, and the
    step, normalizing on the device when
    cfg.tpu.device_normalize and drawing DropPath masks from (seed, step);
    with a process group, the step of one rank of the data-parallel
    global batch (parallel/train.py).  Returns (optimizer, scheduler,
    step)."""
    opt, lr = cfg["optimizer"], cfg["lr_config"]
    if opt["type"] not in ("SGD", "AdamW"):
        raise NotImplementedError(f"optimizer {opt['type']} is not ported")
    train.freeze(model, train.default_frozen_prefixes(
        cfg["model"]["backbone"].get("frozen_stages", 1)))
    schedule = train.lr_schedule(
        base_lr=opt["lr"], warmup_iters=lr["warmup_iters"],
        warmup_ratio=lr["warmup_ratio"], step_epochs=lr["step"],
        iters_per_epoch=iters_per_epoch)
    optimizer, scheduler = train.build_optimizer(
        model, schedule, optimizer=opt["type"].lower(),
        momentum=opt.get("momentum", 0.9),
        weight_decay=opt.get("weight_decay", 1e-4))
    step = train.make_train_step(
        model, build_loss_config(cfg), optimizer, scheduler,
        grad_clip=cfg["optimizer_config"]["grad_clip"]["max_norm"],
        img_norm=build_img_norm(cfg), seed=seed, group=group)
    return optimizer, scheduler, step


def train_epochs(model, loader, step, optimizer, scheduler, ckpt_dir: str,
                 stop_epoch: int, start_epoch: int = 0, it: int = 0,
                 max_iters: int | None = None, ckpt_interval: int = 1,
                 meta: dict | None = None,
                 log: Callable[[str], None] | None = None,
                 log_interval: int = 50, on_step=None, on_epoch=None,
                 group=None) -> dict:
    """The training loop: the loader's epochs start_epoch .. stop_epoch - 1
    through step, each step ended by a synchronize of the model's device
    (so its time is the step's), until `it` reaches max_iters.  A
    checkpoint ckpt_dir/epoch_N.pt (step count `it`, meta) after every
    ckpt_interval-th epoch and after the last epoch run.  log(line) every
    log_interval steps (the losses, LR, seconds so far and the loader's
    share of them) and 'epoch E done in Xs' at each epoch's end, before its
    checkpoint; on_step(epoch, losses, stats, batch) after each
    step, with stats as compute_losses fills them; on_epoch(epoch_reached,
    it) after each epoch's checkpoint.  With a data-parallel group only
    rank 0 logs and writes the checkpoints, and every rank waits at a
    barrier after each write (the losses logged are the group's, the
    step's sums).  Returns dict(epoch: the epoch reached, it, wait_s: the
    wait for each batch, step_s: each step's time, save_s: each
    checkpoint's, wall_s)."""
    device = _device(model)
    if dist.rank(group) != 0:
        log = None
    waits, steps, saves = [], [], []
    t0 = time.perf_counter()
    reached = start_epoch
    loader.epoch = start_epoch
    for epoch in range(start_epoch, stop_epoch):
        t_ep = time.perf_counter()
        batches = iter(loader)
        try:
            while not (max_iters and it >= max_iters):
                t1 = time.perf_counter()
                batch = next(batches, None)
                t2 = time.perf_counter()
                if batch is None:
                    break
                stats = {}
                losses = step(batch, stats)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                waits.append(t2 - t1)
                steps.append(time.perf_counter() - t2)
                if log and it % log_interval == 0:
                    vals = {k: round(float(v), 4) for k, v in losses.items()}
                    elapsed = time.perf_counter() - t0
                    vals.update(lr=scheduler.get_last_lr()[0],
                                elapsed_s=round(elapsed, 1),
                                loader_wait_share=round(sum(waits) / elapsed,
                                                        3))
                    log(f"epoch {epoch} iter {it} {json.dumps(vals)}")
                it += 1
                if on_step:
                    on_step(epoch, losses, stats, batch)
        finally:
            batches.close()
        if log:  # the JAX tool's line, which tools/analyze_logs reads
            log(f"epoch {epoch} done in {time.perf_counter() - t_ep:.1f}s")
        reached = epoch + 1
        last = reached == stop_epoch or bool(max_iters and it >= max_iters)
        if reached % ckpt_interval == 0 or last:
            t1 = time.perf_counter()
            checkpoint.save_checkpoint(ckpt_dir, reached, model, optimizer,
                                       scheduler, it, meta, group=group)
            saves.append(time.perf_counter() - t1)
        if on_epoch:
            on_epoch(reached, it)
        if last:
            break
    return dict(epoch=reached, it=it, wait_s=waits, step_s=steps,
                save_s=saves, wall_s=time.perf_counter() - t0)


def evaluate_results(results: dict, dataset, iou_thr: float = 0.5,
                     use_07_metric: bool = True):
    """In-memory tile-level oriented mAP of run_inference's results against
    the dataset's annotations -> (mAP, {class: ap}).

    The JAX package's evaluate_results, kept as it is: VOC AP per class
    with the exact polygon IoU behind devkit/evaluation.py's axis-aligned
    prefilter; difficult gts are out of npos and a detection matching one
    is neither TP nor FP.  Only the images present in results are scored
    (a subset run is not charged the misses of tiles it did not infer); a
    class without gts in them is nan and left out of the mean.  Raises
    ValueError when no class has a gt.
    """
    name_to_idx = {
        osp.splitext(info["file_name"])[0]: i
        for i, info in enumerate(dataset.img_infos)
    }
    name_to_idx = {n: i for n, i in name_to_idx.items() if n in results}
    aps = {}
    for ci, cname in enumerate(dataset.CLASSES):
        gt = {}
        npos = 0
        for name, di in name_to_idx.items():
            ann = dataset.anns[di]
            mask = ann["labels"] == (ci + 1)
            boxes = ann["bboxes"][mask]
            difficult = np.asarray(
                ann.get("difficult", np.zeros(len(ann["labels"])))
            )[mask].astype(bool)
            gt[name] = dict(bbox=boxes, difficult=difficult,
                            det=[False] * len(boxes))
            npos += int((~difficult).sum())
        recs = []
        for name, per_class in results.items():
            if name not in name_to_idx:
                continue
            for row in np.asarray(per_class[ci]).reshape(-1, 9):
                recs.append((name, row[8], row[:8]))
        if not recs or npos == 0:
            aps[cname] = 0.0 if npos > 0 else float("nan")
            continue
        recs.sort(key=lambda r: -r[1])
        tp = np.zeros(len(recs))
        fp = np.zeros(len(recs))
        for d, (name, score, poly) in enumerate(recs):
            R = gt[name]
            ovmax, jmax = -np.inf, -1
            gts = R["bbox"]
            if gts.size > 0:
                cand = np.where(
                    _hbb_iou_prefilter(gts.astype(np.float64),
                                       poly.astype(np.float64)) > 0
                )[0]
                overlaps = poly_iou_pairs(gts[cand], poly)
                if overlaps.size > 0:
                    k = int(np.argmax(overlaps))
                    ovmax, jmax = overlaps[k], int(cand[k])
            if ovmax > iou_thr:
                if not R["difficult"][jmax]:
                    if not R["det"][jmax]:
                        tp[d] = 1
                        R["det"][jmax] = True
                    else:
                        fp[d] = 1
            else:
                fp[d] = 1
        fp = np.cumsum(fp)
        tp = np.cumsum(tp)
        rec = tp / max(npos, 1)
        prec = tp / np.maximum(tp + fp, 1e-9)
        aps[cname] = voc_ap(rec, prec, use_07_metric)
    valid_aps = [v for v in aps.values() if not np.isnan(v)]
    if not valid_aps:
        raise ValueError(
            "evaluate_results: no ground-truth annotations in the scored "
            "images (every class has npos == 0); tile-level eval needs an "
            "annotated json (dota2coco_train's), and a DOTA test-split json "
            "has none: score those with the devkit's Task1 evaluator "
            "against labelTxt")
    return float(np.mean(valid_aps)), aps
