"""optimizer_ms.train: host milliseconds a step inside the program's
orp.train.optimizer span (the clip, the optimizer, the schedule)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.host_s,
                                  "orp.train.optimizer", 1e3)
