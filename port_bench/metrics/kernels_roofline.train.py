"""kernels_roofline.train: the training step's kernels' least time (from
each launch's shapes, port_bench/yardstick) over their device time."""

from port_bench.yardstick.kernels import roofline_share, wraps

NAMES = ("min_area_rect", "hull_quad_iou", "deform_sample_pair",
         "deform_sample_pair_backward", "convex_giou")
WRAPS = wraps(NAMES)


def read(run):
    return roofline_share(run, NAMES)
