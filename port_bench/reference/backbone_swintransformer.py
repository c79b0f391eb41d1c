"""Swin Transformer (Liu et al. 2021): the reference backbone of a config
whose backbone type is SwinTransformer.

Patch embedding 4 x 4, shifted-window attention with the relative position
bias table, the -100 mask between regions of the rolled map, tanh GELU in
the MLP, LayerNorm with epsilon 1e-6 (flax's), patch merging in the order
(0, 0), (1, 0), (0, 1), (1, 1), one LayerNorm on each emitted stage.
DropPath keeps a sample where jax.random.bernoulli draws true under flax's
make_rng("dropout") key of the block (its n-th draw: 1 after the attention,
2 after the MLP), folded into the step's key (jax_random.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import jax_random
from .ops import conv2d, layer_norm, linear, matmul

TRUNC = 0.02
PERTURB_STD = 0.02  # of the biases and norm affines of seeded weights
# the FPN's wiring where the config leaves it out, as the port's detector
# wires it over this backbone (its extra levels subsample the last one)
NECK_DEFAULTS = {"start_level": 0, "add_extra_convs": False}


def tiny(cfg: dict) -> None:
    """Narrow the config's backbone, and the neck's in_channels to match,
    for the CPU tests: embed_dim 32, two blocks a stage."""
    m = cfg["model"]
    m["backbone"].update(embed_dim=32, depths=[2, 2, 2, 2],
                         num_heads=[1, 2, 4, 8])
    m["neck"]["in_channels"] = [64, 128, 256]


def _blocks(bb: dict):
    """(name, stage, dim, heads, shift, drop rate) of every block."""
    depths = bb.get("depths", (2, 2, 6, 2))
    heads = bb.get("num_heads", (3, 6, 12, 24))
    ws = bb.get("window_size", 7)
    rates = np.linspace(0, bb.get("drop_path_rate", 0.2), sum(depths))
    out, i, dim = [], 0, bb.get("embed_dim", 96)
    for s, n in enumerate(depths):
        for d in range(n):
            out.append((f"stage{s}_block{d}", s, dim, heads[s],
                        0 if d % 2 == 0 else ws // 2, float(rates[i])))
            i += 1
        dim *= 2
    return out


def out_channels(bb: dict) -> list[int]:
    e = bb.get("embed_dim", 96)
    return [e * 2 ** s for s in bb.get("out_indices", (1, 2, 3))]


def spec(bb: dict, prefix: str = "backbone") -> list:
    e, ws = bb.get("embed_dim", 96), bb.get("window_size", 7)
    n_stages = len(bb.get("depths", (2, 2, 6, 2)))
    outs = tuple(bb.get("out_indices", (1, 2, 3)))
    t, one, zero = ("trunc", TRUNC), ("const", 1.0), ("const", 0.0)

    def ln(name, d):
        return [(f"{name}.weight", (d,), one), (f"{name}.bias", (d,), zero)]

    def dense(name, cin, cout, bias=True):
        return [(f"{name}.weight", (cout, cin), t)] + (
            [(f"{name}.bias", (cout,), zero)] if bias else [])

    out = [(f"{prefix}.patch_embed.weight", (e, 3, 4, 4), t),
           (f"{prefix}.patch_embed.bias", (e,), zero)]
    out += ln(f"{prefix}.patch_norm", e)
    blocks = _blocks(bb)
    for s in range(n_stages):
        dim = e * 2 ** s
        for name, st, _, heads, _, _ in blocks:
            if st != s:
                continue
            pre = f"{prefix}.{name}"
            out += ln(pre + ".norm1", dim)
            out += [(pre + ".attn.relative_position_bias_table",
                     ((2 * ws - 1) ** 2, heads), t)]
            out += dense(pre + ".attn.qkv", dim, 3 * dim)
            out += dense(pre + ".attn.proj", dim, dim)
            out += ln(pre + ".norm2", dim)
            out += dense(pre + ".mlp_fc1", dim, 4 * dim)
            out += dense(pre + ".mlp_fc2", 4 * dim, dim)
        if s in outs:
            out += ln(f"{prefix}.out_norm{s}", dim)
        if s < n_stages - 1:
            out += ln(f"{prefix}.merge{s}.norm", 4 * dim)
            out += dense(f"{prefix}.merge{s}.reduction", 4 * dim, 2 * dim,
                         bias=False)
    return out


def frozen_prefixes(bb: dict, prefix: str = "backbone") -> list[str]:
    return []  # no stem or layer names: frozen_stages freezes nothing


def perturb(params: dict, gen: torch.Generator,
            prefix: str = "backbone") -> None:
    """Seeded weights as trained ones have them: every bias and norm
    affine of the backbone plus a normal(0, PERTURB_STD) draw, one draw on
    `gen` for all of them.  With zero biases a canvas's zero padding stays
    exactly 0 through the backbone, its LayerNorms divide by sqrt(1e-6)
    and the grads overflow."""
    names = [k for k, t in params.items()
             if k.startswith(prefix + ".") and t.dim() == 1]
    z = torch.randn(sum(params[k].numel() for k in names), generator=gen,
                    device=gen.device) * PERTURB_STD
    lo = 0
    for k in names:
        n = params[k].numel()
        params[k] = params[k] + z[lo:lo + n]
        lo += n


def rel_index(ws: int) -> torch.Tensor:
    c = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    c = c.reshape(2, -1)
    r = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return torch.from_numpy((r[..., 0] * (2 * ws - 1) + r[..., 1])
                            .reshape(-1).astype(np.int64))


def shift_mask(hp: int, wp: int, ws: int, shift: int) -> torch.Tensor:
    img = np.zeros((hp, wp), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0)
                            .astype(np.float32))


def drop_masks(bb: dict, key, b: int, prefix: str = "backbone"):
    """{block: (keep after attention, keep after MLP)} as (b,) bool numpy,
    for the blocks of a nonzero rate."""
    out = {}
    for name, _, _, _, _, rate in _blocks(bb):
        if rate == 0.0:
            continue
        keep = np.float32(1.0 - rate)
        out[name] = tuple(
            jax_random.uniform(jax_random.fold_in(
                key, jax_random.static_hash((prefix, name, n))), (b,)) < keep
            for n in (1, 2))
    return out


def _windows(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _unwindows(x, ws, h, w):
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _attention(p, pre, x, heads, ws, mask):
    nwb, n, c = x.shape
    hd = c // heads
    qkv = linear(x, p[pre + ".qkv.weight"], p[pre + ".qkv.bias"])
    qkv = qkv.reshape(nwb, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    a = matmul(qkv[0] * hd ** -0.5, qkv[1].transpose(-2, -1))
    table = p[pre + ".relative_position_bias_table"]
    bias = table[rel_index(ws).to(x.device)].reshape(n, n, heads)
    a = a + bias.permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        a = (a.reshape(nwb // nw, nw, heads, n, n)
             + mask[None, :, None]).reshape(nwb, heads, n, n)
    out = matmul(torch.softmax(a, -1), qkv[2])
    out = out.transpose(1, 2).reshape(nwb, n, c)
    return linear(out, p[pre + ".proj.weight"], p[pre + ".proj.bias"])


def _drop(y, rate, keep):
    if keep is None or rate == 0.0:
        return y
    m = torch.from_numpy(keep).to(y.device).to(y.dtype)
    return y * m.reshape((-1,) + (1,) * (y.dim() - 1)) / (1.0 - rate)


def forward(p: dict, images, bb: dict, key=None, train=False,
            prefix: str = "backbone"):
    """images (B, H, W, 3) -> the out_indices stages (NCHW).  In train
    mode key is (the step's (2,) uint32 DropPath key, offset, total): these
    images are rows [offset, offset + B) of a batch of `total`, whose masks
    are drawn."""
    ws = bb.get("window_size", 7)
    n_stages = len(bb.get("depths", (2, 2, 6, 2)))
    outs_idx = tuple(bb.get("out_indices", (1, 2, 3)))
    masks = {}
    if train:
        k, lo, total = key
        hi = lo + images.shape[0]
        masks = {n: (a[lo:hi], m[lo:hi]) for n, (a, m) in
                 drop_masks(bb, k, total, prefix).items()}
    h, w = images.shape[1], images.shape[2]
    ph, pw = (-h) % 4, (-w) % 4
    x = F.pad(images, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    x = conv2d(x.permute(0, 3, 1, 2), p[f"{prefix}.patch_embed.weight"],
               p[f"{prefix}.patch_embed.bias"], 4).permute(0, 2, 3, 1)
    x = layer_norm(x, p[f"{prefix}.patch_norm.weight"],
                   p[f"{prefix}.patch_norm.bias"])
    outs = []
    blocks = _blocks(bb)
    for s in range(n_stages):
        for name, st, _, heads, shift, rate in blocks:
            if st != s:
                continue
            pre = f"{prefix}.{name}"
            m_attn, m_mlp = masks.get(name, (None, None))
            b, hh, ww, c = x.shape
            y = layer_norm(x, p[pre + ".norm1.weight"], p[pre + ".norm1.bias"])
            hp, wp = -(-hh // ws) * ws, -(-ww // ws) * ws
            y = F.pad(y, (0, 0, 0, wp - ww, 0, hp - hh))
            mask = None
            if shift:
                y = torch.roll(y, (-shift, -shift), (1, 2))
                mask = shift_mask(hp, wp, ws, shift).to(x.device)
            y = _unwindows(_attention(p, pre + ".attn", _windows(y, ws),
                                      heads, ws, mask), ws, hp, wp)
            if shift:
                y = torch.roll(y, (shift, shift), (1, 2))
            x = x + _drop(y[:, :hh, :ww], rate, m_attn)
            y = layer_norm(x, p[pre + ".norm2.weight"], p[pre + ".norm2.bias"])
            y = linear(y, p[pre + ".mlp_fc1.weight"], p[pre + ".mlp_fc1.bias"])
            y = linear(F.gelu(y, approximate="tanh"),
                       p[pre + ".mlp_fc2.weight"], p[pre + ".mlp_fc2.bias"])
            x = x + _drop(y, rate, m_mlp)
        if s in outs_idx:
            y = layer_norm(x, p[f"{prefix}.out_norm{s}.weight"],
                           p[f"{prefix}.out_norm{s}.bias"])
            outs.append(y.permute(0, 3, 1, 2))
        if s < n_stages - 1:
            hh, ww = x.shape[1], x.shape[2]
            x = F.pad(x, (0, 0, 0, ww % 2, 0, hh % 2))
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
            x = layer_norm(x, p[f"{prefix}.merge{s}.norm.weight"],
                           p[f"{prefix}.merge{s}.norm.bias"])
            x = linear(x, p[f"{prefix}.merge{s}.reduction.weight"])
    return outs
