"""init_detector: config -> model -> optional weights (counterpart of
apis.py::init_detector and utils/builder.py::build_detector), and the
training config readers build_loss_config / build_img_norm
(utils/builder.py)."""

from __future__ import annotations

import torch

from .core.loss_head import LossConfig
from .host import load_config
from .models.detector import OrientedRepPointsDetector

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device) -> torch.device:
    """The device asked for; a CUDA device without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def build_detector(cfg, compute_dtype: str = "bfloat16"):
    m = cfg["model"]
    bb = m["backbone"]
    if bb["type"] != "ResNet" or bb.get("groups", 1) != 1:
        raise NotImplementedError(f"backbone {bb['type']} with groups "
                                  f"{bb.get('groups', 1)} is not ported")
    neck = m["neck"]
    if neck.get("start_level", 1) != 1 or not neck.get("add_extra_convs",
                                                       True):
        raise NotImplementedError("only the ResNet FPN wiring is ported")
    head = m["bbox_head"]
    return OrientedRepPointsDetector(
        depth=bb.get("depth", 50), num_classes=head["num_classes"],
        fpn_out_channels=neck["out_channels"], num_levels=neck["num_outs"],
        dtype=DTYPES[compute_dtype],
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
