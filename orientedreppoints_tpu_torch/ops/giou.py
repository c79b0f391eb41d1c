"""Aligned convex GIoU of 9-point sets' hulls with their gt quads, and its
gradient in the points (no TPU kernel: the JAX package leaves
geometry.convex_giou to XLA, which fuses it; csrc/convex_giou.cu says why
the port has one).

``convex_giou`` and ``convex_giou_grad`` call the custom ops
``orp::convex_giou`` and ``orp::convex_giou_grad``: the CUDA kernel for
CUDA tensors, and for CPU tensors the plain version, chosen by the
dispatcher from the tensor's device: geometry.convex_giou, and for the
gradient autograd through it (``convex_giou_grad_plain``).  The gradient
entry is registered at the CPU autograd key too, since a kernel registered
below autograd runs with autograd off.  Neither op has a derivative of its
own: its callers (core/losses.py's GIoU loss, APAA) take no gradient
through it.
"""

from __future__ import annotations

import torch

from . import _ext
from .geometry import convex_giou as convex_giou_plain

K = 9


@torch.library.custom_op("orp::convex_giou", mutates_args=(),
                         device_types="cpu")
def convex_giou(points: torch.Tensor, quads: torch.Tensor) -> torch.Tensor:
    """points (n, 18), quads (n, 8) float32 -> GIoU (n,)."""
    return convex_giou_plain(points, quads)


@convex_giou.register_kernel("cuda")
def _(points, quads):
    return convex_giou_kernel(points.contiguous(), quads.contiguous())[0]


@convex_giou.register_fake
def _(points, quads):
    return points.new_empty((points.shape[0],), dtype=torch.float32)


@torch.library.custom_op("orp::convex_giou_grad", mutates_args=(),
                         device_types="cpu")
def convex_giou_grad(points: torch.Tensor, quads: torch.Tensor,
                     weight: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """points (n, 18), quads (n, 8), weight (n,) float32 -> (GIoU (n,),
    weight[:, None] * d GIoU / d points (n, 18))."""
    return convex_giou_grad_plain(points, quads, weight)


def convex_giou_grad_plain(points, quads, weight):
    """The plain version: autograd through geometry.convex_giou."""
    with torch.enable_grad():
        p = points.detach().requires_grad_(True)
        giou = convex_giou_plain(p, quads)
        (dgiou,) = torch.autograd.grad(giou, p, grad_outputs=weight)
    return giou.detach(), dgiou


_LIB = torch.library.Library("orp", "FRAGMENT")
_LIB.impl("convex_giou_grad", convex_giou_grad_plain, "AutogradCPU")


@convex_giou_grad.register_kernel("cuda")
def _(points, quads, weight):
    return convex_giou_kernel(points.contiguous(), quads.contiguous(),
                              weight.contiguous())


@convex_giou_grad.register_fake
def _(points, quads, weight):
    n = points.shape[0]
    return (points.new_empty((n,), dtype=torch.float32),
            points.new_empty((n, 2 * K), dtype=torch.float32))


def convex_giou_kernel(points: torch.Tensor, quads: torch.Tensor,
                       weight: torch.Tensor | None = None):
    """CUDA kernel: (n, 18), (n, 8) -> (GIoU (n,),); with weight (n,) ->
    (GIoU (n,), weight-scaled gradient (n, 18))."""
    n = points.shape[0]
    _ext.check_cuda(points, "points", torch.float32, (n, 2 * K))
    _ext.check_cuda(quads, "quads", torch.float32, (n, 8), points.device)
    grad = weight is not None
    out = (torch.empty((n,), dtype=torch.float32, device=points.device),)
    if grad:
        _ext.check_cuda(weight, "weight", torch.float32, (n,), points.device)
        out += (torch.empty((n, 2 * K), dtype=torch.float32,
                            device=points.device),)
    _ext.launch("orp_convex_giou", points.data_ptr(), quads.data_ptr(),
                weight.data_ptr() if grad else None, out[0].data_ptr(),
                out[1].data_ptr() if grad else None, n, on=points)
    convex_giou_kernel.launches += 1
    return out


convex_giou_kernel.launches = 0
