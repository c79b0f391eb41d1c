"""The reference detector: a backbone (the module ``backbone_<type>`` of
this package, found by the config's backbone type; its NECK_DEFAULTS wire
the FPN where the config does not), an FPN with GroupNorm and the Oriented
RepPoints head, in float32 over a flat dict of parameters named as the
detector's state_dict.

FPN: laterals from start_level on, top-down nearest upsampling with half
pixel centres, a 3 x 3 conv on each, then the extra levels: stride-2 convs
from the raw last backbone map (add_extra_convs) or stride-2 subsampling of
the last level.  Head: two towers of 3 x 3 conv + GN(32) + ReLU; the init
points (conv 3 x 3 + ReLU + conv 1 x 1), (dy, dx) per point in units of the
level's stride; both deformable convs sample the tower features at the
init points (bilinear, zero outside the map) and multiply by their
(9 x C, C') weight; class logits and the refine offsets, to which the init
offsets are added.
"""

from __future__ import annotations

import importlib
import math

import torch
import torch.nn.functional as F

from .ops import conv2d, group_norm, matmul

GN_GROUPS = 32


def backbone_module(cfg: dict):
    name = cfg["model"]["backbone"]["type"].lower()
    return importlib.import_module(f"{__package__}.backbone_{name}")


def _neck_wiring(cfg: dict):
    """(start_level, add_extra_convs): the config's, else the backbone
    module's NECK_DEFAULTS."""
    neck = cfg["model"]["neck"]
    default = backbone_module(cfg).NECK_DEFAULTS
    return (neck.get("start_level", default["start_level"]),
            neck.get("add_extra_convs", default["add_extra_convs"]))


def _conv_gn(pre, cin, cout, k, init):
    return [(f"{pre}.conv.weight", (cout, cin, k, k), init),
            (f"{pre}.gn.weight", (cout,), ("const", 1.0)),
            (f"{pre}.gn.bias", (cout,), ("const", 0.0))]


def spec(cfg: dict) -> list:
    """[(state_dict name, shape, (rule, value))]: rule normal (std),
    uniform (bound), trunc (std of a normal cut at 2 sigma), const."""
    m = cfg["model"]
    bb = backbone_module(cfg)
    out = bb.spec(m["backbone"])
    in_ch = bb.out_channels(m["backbone"])
    neck, head = m["neck"], m["bbox_head"]
    oc = neck["out_channels"]
    start, extra = _neck_wiring(cfg)
    used = in_ch[start:]

    def xavier(cin, cout, k):
        return ("uniform", math.sqrt(6.0 / ((cin + cout) * k * k)))

    for i, c in enumerate(used):
        out += _conv_gn(f"neck.lateral_{i}", c, oc, 1, xavier(c, oc, 1))
        out += _conv_gn(f"neck.fpn_{i}", oc, oc, 3, xavier(oc, oc, 3))
    cin = in_ch[-1]
    for i in range(neck["num_outs"] - len(used) if extra else 0):
        out += _conv_gn(f"neck.fpn_extra_{i}", cin, oc, 3, xavier(cin, oc, 3))
        cin = oc
    feat, pfeat = head["feat_channels"], head["point_feat_channels"]
    k, n_cls = head["num_points"], head["num_classes"] - 1
    w01, zero = ("normal", 0.01), ("const", 0.0)
    out += [("bbox_head.cls_dcn_weight", (k, feat, pfeat), w01),
            ("bbox_head.refine_dcn_weight", (k, feat, pfeat), w01)]
    for i in range(head["stacked_convs"]):
        c = head["in_channels"] if i == 0 else feat
        out += _conv_gn(f"bbox_head.cls_conv_{i}", c, feat, 3, w01)
        out += _conv_gn(f"bbox_head.reg_conv_{i}", c, feat, 3, w01)
    for name, cin, cout, ks in (("pts_init_conv", feat, pfeat, 3),
                                ("pts_init_out", pfeat, 2 * k, 1),
                                ("cls_out", pfeat, n_cls, 1),
                                ("pts_refine_out", pfeat, 2 * k, 1)):
        out += [(f"bbox_head.{name}.weight", (cout, cin, ks, ks), w01),
                (f"bbox_head.{name}.bias", (cout,), zero)]
    return out


def trainable(cfg: dict, name: str) -> bool:
    """Whether the recipe updates this state_dict entry."""
    if name.endswith(".bn.mean") or name.endswith(".bn.var"):
        return False
    frozen = backbone_module(cfg).frozen_prefixes(cfg["model"]["backbone"])
    return not any(name.startswith(f) for f in frozen)


def _cgn(p, pre, x, stride=1, act=False):
    w = p[pre + ".conv.weight"]
    x = group_norm(conv2d(x, w, None, stride, w.shape[-1] // 2), GN_GROUPS,
                   p[pre + ".gn.weight"], p[pre + ".gn.bias"])
    return F.relu(x) if act else x


def fpn(p, feats, cfg):
    neck = cfg["model"]["neck"]
    start, extra = _neck_wiring(cfg)
    used = feats[start:]
    lat = [_cgn(p, f"neck.lateral_{i}", x) for i, x in enumerate(used)]
    for i in range(len(lat) - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + F.interpolate(
            lat[i], size=lat[i - 1].shape[-2:], mode="nearest-exact")
    outs = [_cgn(p, f"neck.fpn_{i}", x) for i, x in enumerate(lat)]
    n_extra = neck["num_outs"] - len(used)
    src = feats[-1]
    for i in range(n_extra):
        if extra:
            src = _cgn(p, f"neck.fpn_extra_{i}", src, stride=2)
            outs.append(src)
        else:
            outs.append(outs[-1][:, :, ::2, ::2])
    return outs


def bilinear(feat, py, px):
    """feat (B, H, W, C) at positions (B, M) in pixels, zero outside."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b * h * w, c)
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    y0, x0 = y0.long(), x0.long()
    base = (torch.arange(b, device=feat.device) * (h * w))[:, None]
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0 + dy, x0 + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1) + base).reshape(-1)
        out = out + flat[idx].reshape(b, -1, c) * torch.where(
            ok, wgt, 0.0)[..., None]
    return out


def deform_conv(feat, offsets, weight):
    """feat (B, H, W, C), offsets (B, H, W, 2K) as (dy, dx) of the K = k x k
    samples relative to the pixel (in pixels), weight (K, C, C') ->
    (B, H, W, C')."""
    b, h, w, c = feat.shape
    kk = weight.shape[0]
    off = offsets.reshape(b, h, w, kk, 2)
    iy = torch.arange(h, device=feat.device, dtype=feat.dtype)
    ix = torch.arange(w, device=feat.device, dtype=feat.dtype)
    py = off[..., 0] + iy[None, :, None, None]
    px = off[..., 1] + ix[None, None, :, None]
    cols = bilinear(feat, py.reshape(b, -1), px.reshape(b, -1))
    cols = cols.reshape(b * h * w, kk * c)
    return matmul(cols, weight.reshape(kk * c, -1)).reshape(b, h, w, -1)


def head(p, feats, cfg):
    """Per level NHWC cls_scores, pts_init, pts_refine and base_feats."""
    hd = cfg["model"]["bbox_head"]
    n = hd["stacked_convs"]
    outs = {"cls_scores": [], "pts_init": [], "pts_refine": [],
            "base_feats": []}
    hb = "bbox_head."
    for x in feats:
        cf, pf = x, x
        for i in range(n):
            cf = _cgn(p, f"{hb}cls_conv_{i}", cf, act=True)
            pf = _cgn(p, f"{hb}reg_conv_{i}", pf, act=True)
        init = F.relu(conv2d(pf, p[hb + "pts_init_conv.weight"],
                             p[hb + "pts_init_conv.bias"], 1, 1))
        init = conv2d(init, p[hb + "pts_init_out.weight"],
                      p[hb + "pts_init_out.bias"])
        g = hd.get("gradient_mul", 0.1)
        blend = (1 - g) * init.detach() + g * init
        # the DCN samples at the init points themselves
        off = blend.permute(0, 2, 3, 1)
        cls_d = deform_conv(cf.permute(0, 2, 3, 1), off,
                            p[hb + "cls_dcn_weight"])
        ref_d = deform_conv(pf.permute(0, 2, 3, 1), off,
                            p[hb + "refine_dcn_weight"])
        cls = conv2d(F.relu(cls_d).permute(0, 3, 1, 2),
                     p[hb + "cls_out.weight"], p[hb + "cls_out.bias"])
        ref = conv2d(F.relu(ref_d).permute(0, 3, 1, 2),
                     p[hb + "pts_refine_out.weight"],
                     p[hb + "pts_refine_out.bias"]) + init.detach()
        outs["cls_scores"].append(cls.permute(0, 2, 3, 1))
        outs["pts_init"].append(init.permute(0, 2, 3, 1))
        outs["pts_refine"].append(ref.permute(0, 2, 3, 1))
        outs["base_feats"].append(x.permute(0, 2, 3, 1))
    return outs


def forward(p: dict, images, cfg: dict, key=None, train: bool = False):
    """images (B, H, W, 3) normalized float32 -> the head's dict."""
    bb = backbone_module(cfg)
    feats = bb.forward(p, images, cfg["model"]["backbone"], key=key,
                       train=train)
    return head(p, fpn(p, feats, cfg), cfg)
