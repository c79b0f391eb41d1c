"""launches.serve: kernel launches a batch inside the program's
orp.serve.call span (one batch, entry to per-class results; memcpy and
memset not counted)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.launches,
                                  "orp.serve.call")
