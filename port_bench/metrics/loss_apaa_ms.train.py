"""loss_apaa_ms.train: host milliseconds a step inside the program's
orp.loss.apaa span (APAA without gradient, the final labels)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.host_s,
                                  "orp.loss.apaa", 1e3)
