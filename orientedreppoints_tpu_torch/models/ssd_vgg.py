"""SSD-VGG backbone (counterpart of models/ssd_vgg.py).

VGG 11/13/16/19 (mmcv's arch table, no pool after the last stage, 2x2
pools with ceil_mode), the SSD additions (a stride-1 3x3 max pool, conv6
dilated 6 to 1024, a 1x1 conv7 to 1024), the L2Norm tap after the stage-4
ReLU, the conv7 tap, and the extra layers of input size 300 or 512: 1x1
and 3x3 convs in turn, an 'S' making the next one stride 2 with padding 1
(the others have padding 0), one map after every second extra conv, and
for 512 a last 4x4 conv.  max_outs stops building extras once that many
maps exist (the detector passes its num_levels, so @512 it holds extra0
.. extra5 and no 4x4 conv).  Every conv has a bias, as flax's default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d
from .resnet import he_normal_

VGG_ARCH = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}

EXTRA_SETTING = {
    300: (256, "S", 512, 128, "S", 256, 128, 256, 128, 256),
    512: (256, "S", 512, 128, "S", 256, 128, "S", 256, 128, "S", 256, 128),
}

VGG_WIDTHS = (64, 128, 256, 512, 512)


class L2Norm(nn.Module):
    """Per-channel learned-scale L2 normalization over channels, in f32
    (w * x / (||x|| + eps)), cast back to the input's dtype."""

    def __init__(self, channels: int, scale: float = 20.0,
                 eps: float = 1e-10):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        xf = x.float()
        norm = torch.sqrt((xf * xf).sum(1, keepdim=True)) + self.eps
        return (self.weight[None, :, None, None] * xf / norm).to(x.dtype)


class SSDVGG(nn.Module):
    """VGG + SSD extra layers; returns (l2norm(relu4_3), conv7, extras...)."""

    def __init__(self, input_size: int = 300, depth: int = 16,
                 l2_norm_scale: float = 20.0, max_outs: int | None = None):
        super().__init__()
        if input_size not in EXTRA_SETTING:
            raise ValueError(f"SSDVGG input_size {input_size}: 300 or 512")
        self.stage_convs = VGG_ARCH[depth]
        cin = 3
        for stage, (width, n) in enumerate(zip(VGG_WIDTHS,
                                               self.stage_convs)):
            for i in range(n):
                self.add_module(f"conv{stage + 1}_{i + 1}",
                                Conv2d(cin, width, 3, padding=1))
                cin = width
        self.l2_norm = L2Norm(512, l2_norm_scale)
        self.conv6 = Conv2d(512, 1024, 3, padding=6, dilation=6)
        self.conv7 = Conv2d(1024, 1024, 1)
        self.out_channels = [512, 1024]
        # the extras, as (name, emits a map) in order
        self.extras = []
        cin, num, stride2 = 1024, 0, False
        for e in EXTRA_SETTING[input_size]:
            if max_outs is not None and len(self.out_channels) >= max_outs:
                break
            if e == "S":
                stride2 = True
                continue
            k = (1, 3)[num % 2]
            self.add_module(f"extra{num}", Conv2d(
                cin, e, k, stride=2 if stride2 else 1,
                padding=1 if stride2 else 0))
            cin, stride2, num = e, False, num + 1
            self.extras.append((f"extra{num - 1}", num % 2 == 0))
            if num % 2 == 0:
                self.out_channels.append(e)
        else:
            if input_size == 512:
                self.add_module(f"extra{num}", Conv2d(cin, 256, 4,
                                                      padding=1))
                self.extras.append((f"extra{num}", True))
                self.out_channels.append(256)

    def init_weights(self, gen: torch.Generator):
        """He-normal (fan_out) conv weights, zero biases; L2Norm keeps its
        scale."""
        he_normal_(self, gen)

    def forward(self, x):
        outs = []
        for stage, n in enumerate(self.stage_convs):
            for i in range(n):
                x = F.relu(getattr(self, f"conv{stage + 1}_{i + 1}")(x))
            if stage == 3:
                outs.append(self.l2_norm(x))
            if stage < 4:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = F.max_pool2d(x, 3, 1, 1)
        x = F.relu(self.conv7(F.relu(self.conv6(x))))
        outs.append(x)
        for name, emits in self.extras:
            x = F.relu(getattr(self, name)(x))
            if emits:
                outs.append(x)
        return tuple(outs)
