"""losses_ms.train: host milliseconds a step inside the program's orp.loss
span (compute_losses: assigners, APAA, the losses' forward)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.host_s,
                                  "orp.loss", 1e3)
