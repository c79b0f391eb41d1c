"""forward_ms.serve: device milliseconds a batch of the work launched inside
the program's orp.forward span (the detector's forward: backbone, FPN, head
with the DCN)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.device_s,
                                  "orp.forward", 1e3)
