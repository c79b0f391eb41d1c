"""Detector (a ResNet, ResNeXt, Swin, HRNet or SSD-VGG backbone + FPN +
head) and the inference decode
(counterpart of models/detector.py).

decode_detections: per-level sigmoid in f32 -> top nms_pre by max class
score -> offset_to_pts -> min-area rect -> / scale_factor -> background pad
column -> batched multiclass rotated NMS.  decode_no_nms stops before the
NMS, in the test-scale frame; merge_aug_and_nms maps each TTA aug's boxes
back to the image frame and runs one single-image NMS over them all.  Head
outputs are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.points import offset_to_pts
from ..ops.minarearect import min_area_rect
from ..ops.nms import multiclass_rnms, multiclass_rnms_batch, topk_stable
from ..utils.profiling import annotate
from .fpn import FPN
from .head import OrientedRepPointsHead
from .hrnet import HRNet
from .resnet import ResNet
from .ssd_vgg import SSDVGG
from .swin import SwinTransformer

POINT_STRIDES = (8, 16, 32, 64, 128)


class OrientedRepPointsDetector(nn.Module):
    """Backbone + FPN + head.

    backbone_type: "resnet" (ResNet or ResNeXt), "swin", "hrnet" or
    "ssd_vgg", built with backbone_kwargs.  forward takes (B, H, W, 3)
    normalized images and returns the head's dict of per-level NHWC
    outputs, computed in ``dtype``.  The FPN wiring defaults to the JAX
    package's per backbone: ResNet and HRNet start_level 1 with extra
    convs, Swin start_level 0 with max-pool extra levels, SSD-VGG
    start_level 0 over its first num_levels maps (max_outs) with no extra
    level; fpn_start_level / fpn_add_extra_convs override it when given.
    key is the step's DropPath key a train-mode Swin draws its masks
    under (the other backbones have no stochastic layer and ignore it).
    """

    def __init__(self, backbone_type: str = "resnet", depth: int = 50,
                 num_classes: int = 16, fpn_out_channels: int = 256,
                 num_levels: int = 5, fpn_start_level: int | None = None,
                 fpn_add_extra_convs: bool | None = None,
                 dtype: torch.dtype = torch.float32,
                 backbone_kwargs: dict | None = None,
                 head_kwargs: dict | None = None):
        super().__init__()
        self.dtype = dtype
        self.backbone_type = backbone_type
        kw = backbone_kwargs or {}
        if backbone_type == "resnet":
            self.backbone = ResNet(depth=depth, **kw)
            start, extra = 1, True
        elif backbone_type == "swin":
            # flax names the backbone "backbone": its DropPath keys' path
            self.backbone = SwinTransformer(rng_path=("backbone",), **kw)
            start, extra = 0, False
        elif backbone_type == "ssd_vgg":
            self.backbone = SSDVGG(max_outs=num_levels, **kw)
            start, extra = 0, False
        elif backbone_type == "hrnet":
            self.backbone = HRNet(**kw)
            start, extra = 1, True
        else:
            raise ValueError(f"unknown backbone {backbone_type}")
        if fpn_start_level is not None:
            start = fpn_start_level
        if fpn_add_extra_convs is not None:
            extra = fpn_add_extra_convs
        self.neck = FPN(self.backbone.out_channels, fpn_out_channels,
                        num_levels, start_level=start, add_extra_convs=extra)
        self.bbox_head = OrientedRepPointsHead(
            num_classes=num_classes, in_channels=fpn_out_channels,
            **(head_kwargs or {}))

    def init_weights(self, gen: torch.Generator):
        self.backbone.init_weights(gen)
        self.neck.init_weights(gen)
        self.bbox_head.init_weights(gen)

    def forward(self, images: torch.Tensor, key=None) -> dict:
        with annotate("orp.forward"):
            if self.backbone_type == "swin":
                feats = self.backbone(images.to(self.dtype), key)
            else:
                x = images.permute(0, 3, 1, 2).to(self.dtype)
                feats = self.backbone(
                    x.contiguous(memory_format=torch.channels_last))
            return self.bbox_head(self.neck(feats))


def _decode_candidates(outs: dict, strides: Sequence[int], nms_pre: int):
    """Per level the top nms_pre locations by max class score -> (sigmoid
    scores (B, N, C), point sets (B, N, 18), min-area rects (B, N, 8)) in
    the test-scale frame."""
    lvl_scores, lvl_pts = [], []
    for lvl, stride in enumerate(strides):
        s = outs["cls_scores"][lvl]
        b, h, w, c = s.shape
        scores = torch.sigmoid(s.reshape(b, h * w, c).to(torch.float32))
        pts = offset_to_pts(outs["pts_refine"][lvl].to(torch.float32), stride)
        k = min(nms_pre, h * w)
        topk = topk_stable(scores.amax(-1), k)[1]
        lvl_scores.append(torch.gather(scores, 1,
                                       topk[..., None].expand(-1, -1, c)))
        lvl_pts.append(torch.gather(pts, 1, topk[..., None].expand(
            -1, -1, pts.shape[-1])))
    all_scores = torch.cat(lvl_scores, 1)
    all_pts = torch.cat(lvl_pts, 1)
    b, n, _ = all_pts.shape
    boxes = min_area_rect(all_pts.reshape(b * n, -1).contiguous())
    return all_scores, all_pts, boxes.reshape(b, n, 8)


def _pad_background(scores: torch.Tensor) -> torch.Tensor:
    """The use_sigmoid_cls background column 0."""
    return torch.cat([torch.zeros_like(scores[..., :1]), scores], -1)


def decode_detections(outs: dict, strides: Sequence[int] = POINT_STRIDES,
                      nms_pre: int = 2000, score_thr: float = 0.05,
                      iou_thr: float = 0.4, max_per_img: int = 2000,
                      scale_factor: float | torch.Tensor = 1.0,
                      with_reppoints: bool = True, pre_nms_cap: int = 4096):
    """Head outputs -> (dets (B, max_per_img, 27|9), labels, valid).

    dets rows are [reppoints(18)?, poly(8), score]; scale_factor (scalar or
    (B, 1, 1)) is undone on polys and points.
    """
    with annotate("orp.decode"):
        all_scores, all_pts, boxes = _decode_candidates(outs, strides,
                                                        nms_pre)
        sf = torch.as_tensor(scale_factor, dtype=torch.float32,
                             device=all_pts.device)
        return multiclass_rnms_batch(
            boxes / sf, _pad_background(all_scores), score_thr, iou_thr,
            max_per_img, reppoints=all_pts / sf if with_reppoints else None,
            pre_nms_cap=pre_nms_cap)


def decode_no_nms(outs: dict, strides: Sequence[int] = POINT_STRIDES,
                  nms_pre: int = 2000):
    """Per-level top-k decode without NMS (the aug_test path): (boxes
    (B, N, 8), scores (B, N, C+1) with the background column) in the
    test-scale frame."""
    all_scores, _, boxes = _decode_candidates(outs, strides, nms_pre)
    return boxes, _pad_background(all_scores)


def merge_aug_and_nms(aug_boxes, aug_scores, flips, img_shape, scale_factor,
                      score_thr: float = 0.05, iou_thr: float = 0.4,
                      max_per_img: int = 2000, pre_nms_cap: int = 4096):
    """Multi-scale / flip TTA merge of one image: each aug's (N_a, 8) boxes
    are unflipped in that aug's own frame (x -> w - x - 1), then divided by
    its scale factor; the concatenated candidates go through one
    single-image multiclass_rnms.

    img_shape: one (h, w) or one per aug (the frame the flip was applied
    in); scale_factor: one scalar or one per aug (float or 0-d tensor).
    Returns (dets (max_per_img, 9), labels, valid).
    """
    n = len(aug_boxes)
    shapes = (img_shape if isinstance(img_shape, (list, tuple))
              and isinstance(img_shape[0], (list, tuple)) else [img_shape] * n)
    sfs = (list(scale_factor) if isinstance(scale_factor, (list, tuple))
           else [scale_factor] * n)
    recovered = []
    for boxes, flip, shp, sf in zip(aug_boxes, flips, shapes, sfs):
        if flip:
            boxes = boxes.clone()
            boxes[:, 0::2] = shp[1] - boxes[:, 0::2] - 1
        recovered.append(boxes / torch.as_tensor(sf, dtype=torch.float32,
                                                 device=boxes.device))
    return multiclass_rnms(torch.cat(recovered), torch.cat(aug_scores),
                           score_thr, iou_thr, max_per_img,
                           pre_nms_cap=pre_nms_cap)
