"""The whole step's share of the card's bf16 peak: the configuration's
frozen FLOPs an image at the mix's canvas (port_bench/configs) times the
images a second of the untraced window that the traced run makes before
its profiled one, over 989 TFLOP/s.  The profiler slows the host, so the
traced window's own rate would read low.  No FLOPs frozen at that canvas:
nothing to read."""

from port_bench.yardstick import peaks

WRAPS = []


def read(run):
    flops = run.conf["flops_per_image"][run.kind].get(str(run.canvas))
    if flops is None:
        return None
    return 100.0 * flops * run.rate / peaks.BF16_FLOPS
