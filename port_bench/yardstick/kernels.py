"""The hand-written kernels the roofline readers measure: for each, the
launcher the harness records calls of (module, attribute), the function
of roofline.py that gives a call's least time, the __global__ names of
its device code in the trace, and the launcher's arguments that function
reads by value (each image's candidate count), the rest by shape."""

from __future__ import annotations

from . import roofline

_OPS = "orientedreppoints_tpu_torch.ops"
KERNELS = {
    "min_area_rect": (f"{_OPS}.minarearect", "min_area_rect_kernel",
                      roofline.min_area_rect, ("mar_kernel",), ()),
    "quad_over_mask": (f"{_OPS}.quad_iou", "quad_over_mask_kernel",
                       roofline.quad_over_mask, ("quad_over_kernel",),
                       ("num_valid",)),
    "nms_scan": (f"{_OPS}.nms", "greedy_scan_kernel", roofline.greedy_scan,
                 ("nms_scan_kernel",), ("num_valid",)),
    "deform_sample_pair": (f"{_OPS}.deform_conv", "deform_sample_pair_kernel",
                           roofline.deform_sample_pair,
                           ("deform_sample_pair_kernel",), ()),
    "hull_quad_iou": (f"{_OPS}.hull_iou", "hull_quad_iou_kernel",
                      roofline.hull_quad_iou, ("hull_quad_iou_kernel",), ()),
    "deform_sample_pair_backward": (
        f"{_OPS}.deform_conv", "deform_sample_pair_backward_kernel",
        roofline.deform_sample_pair_backward,
        ("deform_sample_pair_bwd_", "tg_count", "tg_chunk_sums",
         "tg_chunk_scan", "tg_place", "tg_sort_long"), ()),
    "convex_giou": (f"{_OPS}.giou", "convex_giou_kernel",
                    roofline.convex_giou, ("convex_giou_kernel",), ()),
}


def wraps(names):
    return [(KERNELS[n][0], KERNELS[n][1], "k." + n, KERNELS[n][4])
            for n in names]


def roofline_share(run, names):
    """100 x the least time of the recorded launches over the device time
    of their kernels in the window; None without launches or kernels."""
    least = dev = 0.0
    for n in names:
        calls = run.rec.calls.get("k." + n, [])
        if not calls:
            continue
        fn, patterns = KERNELS[n][2], KERNELS[n][3]
        least += sum(fn(*args, **kwargs) for args, kwargs in calls)
        dev += run.view.kernel_s(patterns)
    if least <= 0.0 or dev <= 0.0:
        return None
    return 100.0 * least / dev
