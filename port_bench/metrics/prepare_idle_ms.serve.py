"""prepare_idle_ms.serve: device idle milliseconds a batch in gaps ended by
work launched inside the program's orp.serve.prepare span (the per-image
copies to the card from pageable memory, resize, normalize, paste)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.idle_s,
                                  "orp.serve.prepare", 1e3)
