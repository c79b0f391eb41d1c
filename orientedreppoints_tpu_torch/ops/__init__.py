"""Geometry, NMS and deformable-conv ops, each CUDA kernel beside its plain
PyTorch version.  KERNELS maps each kernel's name to its launching function,
whose ``launches`` attribute counts its launches."""

from .deform_conv import (deform_sample_pair_backward_kernel,
                          deform_sample_pair_kernel)
from .hull_iou import hull_quad_iou_kernel
from .minarearect import min_area_rect_kernel
from .nms import greedy_scan_kernel
from .quad_iou import quad_over_mask_kernel

KERNELS = {
    "min_area_rect": min_area_rect_kernel,
    "quad_over_mask": quad_over_mask_kernel,
    "nms_scan": greedy_scan_kernel,
    "deform_sample_pair": deform_sample_pair_kernel,
    "hull_quad_iou": hull_quad_iou_kernel,
    "deform_sample_pair_backward": deform_sample_pair_backward_kernel,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
