"""loss_launches.train: kernel launches a step inside the program's orp.loss
span (compute_losses; memcpy and memset not counted)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.launches,
                                  "orp.loss")
