"""The reference's products and norms, in float32 with TF32 off.

Every matrix product of the reference (convolutions, dense layers, the
attention products and the DCN's im2col product) goes through ``conv2d``,
``linear`` or ``matmul`` here, so that one switch can run the whole
reference at a lower precision: ``lower_precision("float8_e4m3fn")`` rounds
both operands of every product to that format (one scale a tensor, its
largest magnitude mapped to the format's largest finite value), and the
gradient arriving at each product's output in the backward, and
multiplies the rounded values in float32.  That is the control that a
correct comparison has to fail.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_ROUND = None  # None: float32 operands; else fn(t) -> t rounded


def f32_no_tf32() -> None:
    """float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def f32_inside():
    """f32_no_tf32() inside the block; the settings as they were after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    f32_no_tf32()
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def _round_to(dtype: torch.dtype):
    top = float(torch.finfo(dtype).max)
    scaled = top < 1e5  # the float8 formats need a scale, 16-bit ones not

    def rnd(t: torch.Tensor) -> torch.Tensor:
        x = t.detach()
        if scaled:
            scale = x.abs().amax().float().clamp(min=1e-30) / top
            r = (x / scale).to(dtype).to(t.dtype) * scale
        else:
            r = x.to(dtype).to(t.dtype)
        # a straight-through rounding: the grads flow as through identity
        return t + (r - x)

    return rnd


@contextlib.contextmanager
def lower_precision(dtype_name: str | None):
    """Round every product's operands to dtype_name inside the block."""
    global _ROUND
    old = _ROUND
    _ROUND = None if dtype_name is None else _round_to(getattr(torch,
                                                               dtype_name))
    try:
        yield
    finally:
        _ROUND = old


def q(t: torch.Tensor) -> torch.Tensor:
    return t if _ROUND is None else _ROUND(t)


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded in the backward, so
    that the backward's products take rounded operands too."""

    @staticmethod
    def forward(ctx, t, rnd):
        ctx.rnd = rnd
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


def qg(t: torch.Tensor) -> torch.Tensor:
    if _ROUND is None or not t.requires_grad:
        return t
    return _RoundGrad.apply(t, _ROUND)


def conv2d(x, w, b=None, stride=1, padding=0, groups=1):
    return qg(F.conv2d(q(x), q(w), b, stride, padding, 1, groups))


def linear(x, w, b=None):
    return qg(F.linear(q(x), q(w), b))


def matmul(a, b):
    return qg(torch.matmul(q(a), q(b)))


def group_norm(x, groups: int, w, b, eps: float = 1e-6):
    """GroupNorm over NCHW (flax's epsilon 1e-6)."""
    n, c = x.shape[:2]
    g = x.reshape(n, groups, -1)
    mean = g.mean(-1, keepdim=True)
    var = ((g - mean) ** 2).mean(-1, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * w.reshape(shape) + b.reshape(shape)


def layer_norm(x, w, b, eps: float = 1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def frozen_bn(x, p: dict, prefix: str, eps: float = 1e-5):
    """Batch norm with stored statistics over NCHW."""
    scale = p[prefix + ".scale"] / torch.sqrt(p[prefix + ".var"] + eps)
    shift = p[prefix + ".bias"] - p[prefix + ".mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]
