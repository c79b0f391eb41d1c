"""Swin Transformer backbone (counterpart of models/swin.py).

Swin-Tiny as the reference configures it: patch 4, window 7, depths
(2, 2, 6, 2), heads (3, 6, 12, 24), mlp ratio 4, qkv bias, no absolute
position embedding, patch_norm on, DropPath linear over depth, one
LayerNorm per emitted stage.  Works in NHWC, as the JAX module does, and
hands each emitted stage back as an NCHW view of an NHWC tensor (channels
last), the layout the FPN and head take.

Numerics follow the flax module, each point a place where PyTorch's
defaults differ:
  * LayerNorm: epsilon 1e-6, computed in f32, then cast to the compute
    dtype;
  * GELU: the tanh approximation (flax nn.gelu);
  * attention: q scaled in the compute dtype; the logits and the
    attention-times-v product are summed in f32 (the bf16 operands are
    upcast: their products are exact in f32), the f32 bias table and the
    -100 / 0 shift mask added in f32, the softmax in f32 and then cast;
  * the shift is unconditional when a block has one, also where the
    window covers the whole (padded) map;
  * the map is padded to window multiples after norm1, and cropped after
    the reverse roll;
  * DropPath draws one keep mask per sample from the torch.Generator the
    caller passes (the train step derives it from its seed and step
    count); the model draws nothing in eval mode.

The window attention, LayerNorm, GELU and PatchMerging are XLA code in
the JAX package, not Pallas kernels; here they are plain PyTorch, and the
Dense products go to F.linear / torch.matmul.  Parameters are f32 and are
cast to the input's dtype at use; names follow the flax tree, so
utils/convert.py maps every leaf one to one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d

LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)
INIT_STD = 0.02
# flax truncated_normal(stddev) draws a unit normal cut at +-2 and scales
# it by stddev / 0.87962566 (the cut normal's std), so that the result has
# std `stddev`
_TRUNC_STD_OF_UNIT = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, gen: torch.Generator,
                  stddev: float = INIT_STD) -> None:
    """flax's truncated_normal(stddev) initializer."""
    sigma = stddev / _TRUNC_STD_OF_UNIT
    nn.init.trunc_normal_(t, std=sigma, a=-2 * sigma, b=2 * sigma,
                          generator=gen)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 relative bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Additive (-100 / 0) mask (nW, ws*ws, ws*ws) of the shifted windows
    of an hp x wp map: pairs from different regions of the rolled map are
    masked."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, hp // ws, ws, wp // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nH*nW, ws*ws, C); H, W divisible by ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int,
                   w: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def drop_path(y: torch.Tensor, rate: float,
              gen: torch.Generator | None) -> torch.Tensor:
    """Stochastic depth: y times a per-sample keep mask (B, 1, 1, 1) drawn
    from gen, over keep = 1 - rate.  Identity without gen or at rate 0."""
    if gen is None or rate == 0.0:
        return y
    keep = 1.0 - rate
    shape = (y.shape[0],) + (1,) * (y.dim() - 1)
    mask = torch.rand(shape, generator=gen, device=y.device) < keep
    return y * mask.to(y.dtype) / keep


class Linear(nn.Linear):
    """nn.Linear run in the input's dtype with f32 parameters (flax Dense
    with dtype=)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm(dtype=float32): epsilon 1e-6, an f32 result."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = Linear(dim, dim)
        self.register_buffer(
            "rel_index",
            torch.from_numpy(relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """x: (nW*B, N, C) in the compute dtype; mask: (nW, N, N) f32
        additive or None."""
        nwb, n, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(x).reshape(nwb, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]  # (nwb, h, n, hd)
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
        bias = self.relative_position_bias_table[self.rel_index]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(nwb // nw, nw, h, n, n)
                    + mask[None, :, None]).reshape(nwb, h, n, n)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)
        return self.proj(out.transpose(1, 2).reshape(nwb, n, c))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim)
        self._masks: dict = {}  # (hp, wp, device) -> the shift mask

    def _mask(self, hp: int, wp: int, device) -> torch.Tensor:
        key = (hp, wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shift_attn_mask(
                hp, wp, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor,
                gen: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, H, W, C) in the compute dtype."""
        b, h, w, c = x.shape
        ws = self.window_size
        y = self.norm1(x).to(x.dtype)
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        mask = None
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), (1, 2))
            mask = self._mask(hp, wp, x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws,
                           hp, wp)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), (1, 2))
        x = x + drop_path(y[:, :h, :w], self.drop_path, gen)
        y = self.mlp_fc1(self.norm2(x).to(x.dtype))
        y = self.mlp_fc2(F.gelu(y, approximate="tanh"))
        return x + drop_path(y, self.drop_path, gen)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        # the 2x2 neighbourhood in the reference's order (0,0), (1,0),
        # (0,1), (1,1)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x).to(x.dtype))


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """flax padding="SAME" of one spatial dim: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class SwinTransformer(nn.Module):
    """forward((B, H, W, 3) images in the compute dtype, gen) -> the
    out_indices stages as NCHW views of NHWC tensors (channels last)."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.2,
                 out_indices: Sequence[int] = (1, 2, 3),
                 patch_norm: bool = True):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = Conv2d(3, embed_dim, 4, 4)
        self.patch_norm = LayerNorm(embed_dim) if patch_norm else None
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        self.stages = []
        blk_id, dim = 0, embed_dim
        for stage, depth in enumerate(depths):
            names = []
            for d in range(depth):
                name = f"stage{stage}_block{d}"
                self.add_module(name, SwinBlock(
                    dim, num_heads[stage], window_size,
                    shift=0 if d % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio, drop_path=float(dpr[blk_id])))
                names.append(name)
                blk_id += 1
            if stage in self.out_indices:
                self.add_module(f"out_norm{stage}", LayerNorm(dim))
            if stage < len(depths) - 1:
                self.add_module(f"merge{stage}", PatchMerging(dim))
                dim *= 2
            self.stages.append(names)
        self.out_channels = [embed_dim * 2 ** s for s in self.out_indices]

    def init_weights(self, gen: torch.Generator):
        """flax's init: truncated normal (0.02) Dense, conv and bias-table
        weights, zero biases, LayerNorm ones and zeros."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (Linear, Conv2d)):
                    trunc_normal_(m.weight, gen)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, WindowAttention):
                    trunc_normal_(m.relative_position_bias_table, gen)
                elif isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    def forward(self, x: torch.Tensor,
                gen: torch.Generator | None = None) -> tuple:
        if self.training and gen is None and any(
                getattr(self, n).drop_path for s in self.stages for n in s):
            raise ValueError("SwinTransformer in train mode needs the "
                             "DropPath generator (gen)")
        gen = gen if self.training else None
        h, w = x.shape[1], x.shape[2]
        ph, pw = _same_pad(h, 4, 4), _same_pad(w, 4, 4)
        x = F.pad(x, (0, 0) + pw + ph).permute(0, 3, 1, 2)
        x = self.patch_embed(x).permute(0, 2, 3, 1).contiguous()
        if self.patch_norm is not None:
            x = self.patch_norm(x).to(x.dtype)
        outs = []
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, gen)
            if stage in self.out_indices:
                y = getattr(self, f"out_norm{stage}")(x).to(x.dtype)
                outs.append(y.permute(0, 3, 1, 2))
            if stage < len(self.stages) - 1:
                x = getattr(self, f"merge{stage}")(x)
        return tuple(outs)
