"""Feature Pyramid Network with GN (counterpart of models/fpn.py).

Laterals over the backbone maps from start_level on (1 over ResNet's
C2..C5, 0 over Swin's C3..C5), top-down nearest upsampling, GN(32) on
every conv and no activations; the extra levels up to num_outs are
stride-2 convs starting from the raw last backbone map
(add_extra_convs), or else each the previous level subsampled by a
stride-2 max pool of window 1 (ceil(H / 2), flax's nn.max_pool(x, (1, 1),
strides=(2, 2))).  Output strides 8..128.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvModule


class FPN(nn.Module):
    def __init__(self, in_channels, out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 1, add_extra_convs: bool = True):
        super().__init__()
        used = list(in_channels[start_level:])
        self.start_level = start_level
        self.n_lat = len(used)
        for i, c in enumerate(used):
            self.add_module(f"lateral_{i}",
                            ConvModule(c, out_channels, 1, act=False))
            self.add_module(f"fpn_{i}",
                            ConvModule(out_channels, out_channels, 3,
                                       act=False))
        self.n_extra = num_outs - self.n_lat
        self.add_extra_convs = add_extra_convs
        cin = in_channels[-1]
        for i in range(self.n_extra if add_extra_convs else 0):
            self.add_module(f"fpn_extra_{i}",
                            ConvModule(cin, out_channels, 3, stride=2,
                                       act=False))
            cin = out_channels

    def init_weights(self, gen: torch.Generator):
        """Xavier-uniform conv weights (flax variance_scaling fan_avg)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv2d):
                    rf = m.kernel_size[0] * m.kernel_size[1]
                    fan_avg = (m.in_channels + m.out_channels) * rf / 2
                    bound = (3.0 / fan_avg) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=gen)

    def forward(self, inputs):
        used = inputs[self.start_level:]
        laterals = [getattr(self, f"lateral_{i}")(x)
                    for i, x in enumerate(used)]
        for i in range(self.n_lat - 1, 0, -1):
            # nearest-exact == jax.image.resize(..., "nearest"): half-pixel
            # source centres; plain "nearest" differs on odd sizes
            up = F.interpolate(laterals[i], size=laterals[i - 1].shape[-2:],
                               mode="nearest-exact")
            laterals[i - 1] = laterals[i - 1] + up
        outs = [getattr(self, f"fpn_{i}")(x) for i, x in enumerate(laterals)]
        if not self.add_extra_convs:
            for _ in range(self.n_extra):
                outs.append(F.max_pool2d(outs[-1], 1, 2))
            return tuple(outs)
        src = inputs[-1]  # extra levels start from the raw C5 map
        for i in range(self.n_extra):
            src = getattr(self, f"fpn_extra_{i}")(src)
            outs.append(src)
        return tuple(outs)
