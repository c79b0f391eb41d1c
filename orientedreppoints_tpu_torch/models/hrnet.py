"""HRNet backbone with frozen BN (counterpart of models/hrnet.py).

The `extra` dict schema of the reference (stage1..stage4: num_modules,
num_branches, block 'BASIC' | 'BOTTLENECK', num_blocks, num_channels).
Two stride-2 3x3 stem convs to 64, stage 1 a plain residual layer, then
per stage a transition and num_modules HRModules, each its parallel
branches and a full cross-resolution fusion.  Returns the 4 branch maps at
strides 4/8/16/32, which feed the FPN like ResNet's C2..C5.

Held to the JAX module, not to mmdet where the two differ: an existing
branch whose width changes at a transition takes its own map (mmdet feeds
it the last branch's and crashes on the width), and the fusion sums in
branch order, skipping the branch itself, which fixes bf16's rounding.
Module names are the flax tree's, so utils/convert.py maps every leaf.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BasicBlock, Bottleneck, _ConvBN, he_normal_

# HRNetV2p-W32, the standard detection config (mmdet configs/hrnet)
HRNET_W32_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(4, 4), num_channels=(32, 64)),
    stage3=dict(num_modules=4, num_branches=3, block="BASIC",
                num_blocks=(4, 4, 4), num_channels=(32, 64, 128)),
    stage4=dict(num_modules=3, num_branches=4, block="BASIC",
                num_blocks=(4, 4, 4, 4), num_channels=(32, 64, 128, 256)),
)

_BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _nearest_up(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor (NCHW): each value
    repeated factor times along H and W, as jnp.repeat does."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class _Branch(nn.Module):
    """num_blocks residual blocks at a fixed width; block 0 has a
    downsample only when the width changes."""

    def __init__(self, cin: int, block: str, width: int, num_blocks: int):
        super().__init__()
        cls = _BLOCKS[block]
        out_ch = width * cls.expansion
        self.num_blocks = num_blocks
        for b in range(num_blocks):
            self.add_module(f"block{b}", cls(cin, width, 1,
                                             b == 0 and cin != out_ch))
            cin = out_ch

    def forward(self, x):
        for b in range(self.num_blocks):
            x = getattr(self, f"block{b}")(x)
        return x


class HRModule(nn.Module):
    """Parallel branches + full cross-resolution fusion.  channels are the
    post-expansion widths, which the inputs already have."""

    def __init__(self, block: str, num_branches: int, num_blocks, channels):
        super().__init__()
        exp = _BLOCKS[block].expansion
        self.n = num_branches
        for i in range(num_branches):
            self.add_module(f"branch{i}", _Branch(
                channels[i], block, channels[i] // exp, num_blocks[i]))
        if num_branches == 1:
            return
        for i in range(num_branches):
            for j in range(num_branches):
                if j > i:  # low-res -> i: 1x1 conv + norm, then upsample
                    self.add_module(f"fuse{i}_{j}", _ConvBN(
                        channels[j], channels[i], 1, 1, act=False))
                elif j < i:  # high-res -> i: stride-2 3x3 chain
                    for k in range(i - j):
                        last = k == i - j - 1
                        self.add_module(f"fuse{i}_{j}_{k}", _ConvBN(
                            channels[j], channels[i] if last else channels[j],
                            3, 2, act=not last))

    def forward(self, xs):
        xs = [getattr(self, f"branch{i}")(x) for i, x in enumerate(xs)]
        if self.n == 1:
            return xs
        fused = []
        for i in range(self.n):
            y = xs[i]
            for j in range(self.n):
                if j > i:
                    z = _nearest_up(getattr(self, f"fuse{i}_{j}")(xs[j]),
                                    2 ** (j - i))
                elif j < i:
                    z = xs[j]
                    for k in range(i - j):
                        z = getattr(self, f"fuse{i}_{j}_{k}")(z)
                else:
                    continue
                y = y + z
            fused.append(F.relu(y))
        return fused


class HRNet(nn.Module):
    """HRNet backbone; returns the branch maps at strides 4/8/16/32."""

    def __init__(self, extra: Mapping[str, Mapping] | None = None):
        super().__init__()
        extra = dict(extra or HRNET_W32_EXTRA)
        self.stem1 = _ConvBN(3, 64, 3, 2)
        self.stem2 = _ConvBN(64, 64, 3, 2)
        s1 = extra["stage1"]
        self.layer1 = _Branch(64, s1["block"], s1["num_channels"][0],
                              s1["num_blocks"][0])
        prev = [s1["num_channels"][0] * _BLOCKS[s1["block"]].expansion]
        # per stage: for each branch the map it starts from (its own, or
        # the last previous one for a new branch) and the transition convs
        # on it; then the stage's modules
        self.plan = []
        for si in (2, 3, 4):
            cfg = extra[f"stage{si}"]
            exp = _BLOCKS[cfg["block"]].expansion
            cur = [c * exp for c in cfg["num_channels"]]
            steps = []
            for i in range(cfg["num_branches"]):
                if i < len(prev):
                    names = ([] if cur[i] == prev[i]
                             else [f"transition{si}_{i}"])
                    for name in names:
                        self.add_module(name, _ConvBN(prev[i], cur[i], 3, 1))
                    steps.append((i, names))
                    continue
                names, cin = [], prev[-1]
                for j in range(i + 1 - len(prev)):
                    out_ch = cur[i] if j == i - len(prev) else prev[-1]
                    names.append(f"transition{si}_{i}_{j}")
                    self.add_module(names[-1], _ConvBN(cin, out_ch, 3, 2))
                    cin = out_ch
                steps.append((-1, names))
            modules = [f"stage{si}_{m}" for m in range(cfg["num_modules"])]
            for name in modules:
                self.add_module(name, HRModule(
                    cfg["block"], cfg["num_branches"], cfg["num_blocks"],
                    cur))
            self.plan.append((steps, modules))
            prev = cur
        self.out_channels = list(prev)

    def init_weights(self, gen: torch.Generator):
        """He-normal (fan_out) conv weights; BN stays the identity."""
        he_normal_(self, gen)

    def forward(self, x):
        x = self.layer1(self.stem2(self.stem1(x)))
        feats = [x]
        for steps, modules in self.plan:
            ins = []
            for src, names in steps:
                z = feats[src]
                for name in names:
                    z = getattr(self, name)(z)
                ins.append(z)
            for name in modules:
                ins = getattr(self, name)(ins)
            feats = ins
        return tuple(feats)
