"""results_ms.serve: host milliseconds a batch inside the program's
orp.serve.results span (rbbox2result: the per-class arrays on the host)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.host_s,
                                  "orp.serve.results", 1e3)
