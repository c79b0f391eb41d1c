"""forward_ms.train: device milliseconds a step of the work launched inside
the program's orp.forward span (the detector's train-mode forward; the
backward is not in it)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.device_s,
                                  "orp.forward", 1e3)
