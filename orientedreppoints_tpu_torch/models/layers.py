"""ConvModule and FrozenBatchNorm (counterpart of models/layers.py).

Parameters stay float32, as flax keeps them; each layer computes in the
dtype of its input, casting weights at use (flax ``dtype=`` semantics).
Names follow the flax tree so utils/convert.py maps leaves one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6  # flax nn.GroupNorm default (torch's default is 1e-5)
BN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in the input's dtype with float32 parameters."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation,
                        self.groups)


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics folded into one multiply-add; the
    coefficients are derived in float32, then cast to the compute dtype.

    The statistics (mean, var) are buffers.  The affine (scale, bias) are
    parameters, as in the flax module: the stages that frozen_stages leaves
    trainable update them (parallel/train.py freezes the others)."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        r = self.scale / torch.sqrt(self.var + self.eps)
        inv = r.to(x.dtype)[None, :, None, None]
        shift = (self.bias - self.mean * r).to(x.dtype)[None, :, None, None]
        return x * inv + shift


def normal_init_(m: nn.Conv2d, std: float, gen: torch.Generator):
    with torch.no_grad():
        m.weight.normal_(0.0, std, generator=gen)
        if m.bias is not None:
            m.bias.zero_()


class ConvModule(nn.Module):
    """conv (no bias) + GN(32) + optional ReLU, as the head and FPN use it."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, act: bool = True, gn_groups: int = 32):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size, stride,
                           padding=kernel_size // 2, bias=False)
        self.gn = GroupNorm(gn_groups, cout, eps=GN_EPS)
        self.act = act

    def forward(self, x):
        x = self.gn(self.conv(x))
        return F.relu(x) if self.act else x
