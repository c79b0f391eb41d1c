"""loss_idle_ms.train: device idle milliseconds a step in gaps ended by work
launched inside the program's orp.loss span (compute_losses)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.idle_s,
                                  "orp.loss", 1e3)
