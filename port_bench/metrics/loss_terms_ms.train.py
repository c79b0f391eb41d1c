"""loss_terms_ms.train: host milliseconds a step inside the program's
orp.loss.terms span (focal, GIoU and spatial terms, the init levels)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.host_s,
                                  "orp.loss.terms", 1e3)
