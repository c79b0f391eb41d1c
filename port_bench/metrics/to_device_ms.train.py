"""to_device_ms.train: host milliseconds a step inside the program's
orp.train.to_device span (the batch's copies to the card)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.host_s,
                                  "orp.train.to_device", 1e3)
