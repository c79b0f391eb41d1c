"""fetch_ms.serve: host milliseconds a batch inside the program's
orp.serve.fetch span: the three results' copies to the host, where the host
waits for the card to finish the batch."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.host_s,
                                  "orp.serve.fetch", 1e3)
