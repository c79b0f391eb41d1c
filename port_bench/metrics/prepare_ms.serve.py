"""prepare_ms.serve: host milliseconds a batch inside the program's
orp.serve.prepare span (Predictor.prepare: the per-image copies to the
card, resize, normalize, paste, stack)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.host_s,
                                  "orp.serve.prepare", 1e3)
