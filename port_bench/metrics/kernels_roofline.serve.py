"""kernels_roofline.serve: the serving kernels' least time (from each
launch's shapes, port_bench/yardstick) over their device time."""

from port_bench.yardstick.kernels import roofline_share, wraps

NAMES = ("min_area_rect", "quad_over_mask", "nms_scan", "deform_sample_pair")
WRAPS = wraps(NAMES)


def read(run):
    return roofline_share(run, NAMES)
