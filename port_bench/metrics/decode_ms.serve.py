"""decode_ms.serve: device milliseconds a batch of the work launched inside
the program's orp.decode span (top-k, min-area rects, over-mask, scan)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.device_s,
                                  "orp.decode", 1e3)
