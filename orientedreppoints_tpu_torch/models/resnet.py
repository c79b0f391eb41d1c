"""ResNet and ResNeXt backbones with frozen BN (counterpart of
models/resnet.py).

pytorch style (stride on the 3x3, grouped for ResNeXt), depths 18-152,
the maps of out_indices among C2..C5 at strides 4/8/16/32.  The JAX
package's space-to-depth stem variant
(``ORP_STEM=s2d``) is a TPU layout rewrite with identical outputs and is
not carried over.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, FrozenBatchNorm

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def he_normal_(module: nn.Module, gen: torch.Generator):
    """He-normal (fan_out) weights for every Conv2d under module (flax's
    variance_scaling(2, fan_out, normal): out channels x kernel area) and
    zero biases, as flax inits them."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
                if m.bias is not None:
                    m.bias.zero_()


class _ConvBN(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, act=True, groups=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, padding=kernel // 2,
                           bias=False, groups=groups)
        self.bn = FrozenBatchNorm(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, features, stride=1, downsample=False):
        super().__init__()
        self.conv1 = _ConvBN(cin, features, 3, stride)
        self.conv2 = _ConvBN(features, features, 3, 1, act=False)
        self.downsample = (_ConvBN(cin, features, 1, stride, act=False)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class Bottleneck(nn.Module):
    """features is the base width (output 4 x features); ResNeXt's groups
    and base_width widen the 1x1 and grouped 3x3 convs to
    int(features * base_width / 64) * groups."""
    expansion = 4

    def __init__(self, cin, features, stride=1, downsample=False, groups=1,
                 base_width=64):
        super().__init__()
        width = int(features * (base_width / 64.0)) * groups
        self.conv1 = _ConvBN(cin, width, 1, 1)
        self.conv2 = _ConvBN(width, width, 3, stride, groups=groups)
        self.conv3 = _ConvBN(width, features * 4, 1, 1, act=False)
        self.downsample = (_ConvBN(cin, features * 4, 1, stride, act=False)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + identity)


class ResNet(nn.Module):
    """Returns the maps of out_indices among (C2, C3, C4, C5); groups > 1
    (with base_width) makes it a ResNeXt, e.g. 32 and 4 for 32x4d.  Every
    stage is built whatever out_indices holds, as in the flax tree."""

    def __init__(self, depth: int = 50, out_indices=(0, 1, 2, 3),
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        block_type, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = BasicBlock if block_type == "basic" else Bottleneck
        kw = (dict(groups=groups, base_width=base_width)
              if block_type == "bottleneck" else {})
        self.out_indices = tuple(out_indices)
        self.stem = _ConvBN(3, 64, 7, 2)
        self.stages = []
        cin, width = 64, 64
        for stage, num_blocks in enumerate(stage_blocks):
            names = []
            for blk in range(num_blocks):
                stride = (1 if stage == 0 else 2) if blk == 0 else 1
                needs_ds = blk == 0 and (
                    stride != 1 or cin != width * block_cls.expansion)
                name = f"layer{stage + 1}_{blk}"
                self.add_module(name, block_cls(cin, width, stride, needs_ds,
                                                **kw))
                cin = width * block_cls.expansion
                names.append(name)
            self.stages.append(names)
            width *= 2
        self.out_channels = [64 * block_cls.expansion * 2 ** i
                             for i in self.out_indices]

    def init_weights(self, gen: torch.Generator):
        """He-normal (fan_out) conv weights; BN stays the identity."""
        he_normal_(self, gen)

    def forward(self, x):
        x = self.stem(x)
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
