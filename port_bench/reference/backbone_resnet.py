"""ResNet (pytorch style: the stride on the 3x3) with frozen batch norm:
the reference backbone of a config whose backbone type is ResNet.

Parameters are a flat dict of float32 tensors under the detector's
state_dict names; ``spec`` lists them with the rule each is drawn by.
"""

from __future__ import annotations

import math

import torch.nn.functional as F

from .ops import conv2d, frozen_bn

STAGES = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
          50: ("bottleneck", (3, 4, 6, 3)), 101: ("bottleneck", (3, 4, 23, 3))}
# the FPN's wiring where the config leaves it out, as the port's detector
# wires it over this backbone
NECK_DEFAULTS = {"start_level": 1, "add_extra_convs": True}


def tiny(cfg: dict) -> None:
    """Narrow the config's backbone, and the neck's in_channels to match,
    for the CPU tests: ResNet-18."""
    m = cfg["model"]
    m["backbone"]["depth"] = 18
    m["neck"]["in_channels"] = [64, 128, 256, 512]


def _blocks(bb: dict):
    """(name, kind, cin, width, stride, downsample) of every block."""
    kind, depths = STAGES[bb.get("depth", 50)]
    exp = 4 if kind == "bottleneck" else 1
    cin, width = 64, 64
    out = []
    for s, n in enumerate(depths):
        for b in range(n):
            stride = (1 if s == 0 else 2) if b == 0 else 1
            ds = b == 0 and (stride != 1 or cin != width * exp)
            out.append((f"layer{s + 1}_{b}", kind, cin, width, stride, ds))
            cin = width * exp
        width *= 2
    return out


def out_channels(bb: dict) -> list[int]:
    kind, _ = STAGES[bb.get("depth", 50)]
    exp = 4 if kind == "bottleneck" else 1
    return [64 * exp * 2 ** i for i in range(4)]


def _conv_bn(pre, cin, cout, k):
    fan_out = cout * k * k
    return [(f"{pre}.conv.weight", (cout, cin, k, k),
             ("normal", math.sqrt(2.0 / fan_out))),
            (f"{pre}.bn.scale", (cout,), ("const", 1.0)),
            (f"{pre}.bn.bias", (cout,), ("const", 0.0)),
            (f"{pre}.bn.mean", (cout,), ("const", 0.0)),
            (f"{pre}.bn.var", (cout,), ("const", 1.0))]


def spec(bb: dict, prefix: str = "backbone") -> list:
    out = _conv_bn(f"{prefix}.stem", 3, 64, 7)
    for name, kind, cin, width, _, ds in _blocks(bb):
        pre = f"{prefix}.{name}"
        if kind == "bottleneck":
            out += _conv_bn(f"{pre}.conv1", cin, width, 1)
            out += _conv_bn(f"{pre}.conv2", width, width, 3)
            out += _conv_bn(f"{pre}.conv3", width, width * 4, 1)
            cout = width * 4
        else:
            out += _conv_bn(f"{pre}.conv1", cin, width, 3)
            out += _conv_bn(f"{pre}.conv2", width, width, 3)
            cout = width
        if ds:
            out += _conv_bn(f"{pre}.downsample", cin, cout, 1)
    return out


def frozen_prefixes(bb: dict, prefix: str = "backbone") -> list[str]:
    """frozen_stages: the stem, then layer1 .. layer{frozen_stages}."""
    n = bb.get("frozen_stages", 1)
    out = [f"{prefix}.stem."] if n >= 0 else []
    return out + [f"{prefix}.layer{s}_" for s in range(1, n + 1)]


def _cbr(p, pre, x, stride=1, act=True):
    w = p[pre + ".conv.weight"]
    x = frozen_bn(conv2d(x, w, None, stride, w.shape[-1] // 2), p, pre + ".bn")
    return F.relu(x) if act else x


def forward(p: dict, images, bb: dict, key=None, train=False,
            prefix: str = "backbone"):
    """images (B, H, W, 3) normalized -> C2..C5 (NCHW)."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(_cbr(p, f"{prefix}.stem", x, 2), 3, 2, 1)
    outs, stage = [], "layer1"
    for name, kind, _, _, stride, ds in _blocks(bb):
        if not name.startswith(stage + "_"):
            outs.append(x)
            stage = name.split("_")[0]
        pre = f"{prefix}.{name}"
        idt = _cbr(p, pre + ".downsample", x, stride, False) if ds else x
        if kind == "bottleneck":
            y = _cbr(p, pre + ".conv1", x)
            y = _cbr(p, pre + ".conv2", y, stride)
            y = _cbr(p, pre + ".conv3", y, 1, False)
        else:
            y = _cbr(p, pre + ".conv1", x, stride)
            y = _cbr(p, pre + ".conv2", y, 1, False)
        x = F.relu(y + idt)
    outs.append(x)
    return outs
