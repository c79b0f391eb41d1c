"""loss_assign_ms.train: host milliseconds a step inside the program's
orp.loss.assign span (the level set-up, both assigners, hull IoU)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.host_s,
                                  "orp.loss.assign", 1e3)
