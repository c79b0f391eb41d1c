"""backward_ms.train: device milliseconds a step of the work launched inside
the program's orp.train.backward span (zero_grad and the backward;
autograd's thread launches inside it in time)."""

from port_bench.harness import program_spans

WRAPS = []


def read(run):
    return program_spans.per_step(run, program_spans.device_s,
                                  "orp.train.backward", 1e3)
