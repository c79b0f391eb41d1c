"""The readers of the program's own spans (harness/program_spans.py and
the metrics that use it) on hand-built traces: TraceView's device
readings are the same with the program's ranges in the trace and
without, and it keeps the ranges; each reader gives its hand-computed
value, and nothing on a trace of a program without the spans; every span
a reader reads is one the program opens."""

import json
import re
import types

import pytest

from orientedreppoints_tpu_torch.utils import profiling
from port_bench.harness import main, program_spans, trace
from port_bench.tests.tiny import BENCH, ROOT


def events(*evs):
    out = []
    for cat, name, ts, dur, corr in evs:
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        out.append(e)
    return out


def launch(ts, corr):
    return ("cuda_runtime", "cudaLaunchKernel", ts, 2.0, corr)


def ranges(name, *spans):
    return [("user_annotation", name, a, b - a, None) for a, b in spans]


# two serving batches, times in microseconds
SERVE_PROGRAM = events(
    *ranges("orp.serve.call", (10, 400), (500, 900)),
    *ranges("orp.serve.prepare", (20, 100), (510, 600)),
    *ranges("orp.forward", (150, 240), (610, 700)),
    *ranges("orp.decode", (240, 290), (700, 790)),
    *ranges("orp.serve.fetch", (300, 380), (800, 880)),
    *ranges("orp.serve.results", (380, 395), (880, 895)))
SERVE = events(
    ("user_annotation", "pb.window", 0.0, 1000.0, None),
    launch(30, 1), ("gpu_memcpy", "Memcpy HtoD", 150.0, 20.0, 1),
    launch(200, 2), ("kernel", "void a(int)", 170.0, 80.0, 2),
    launch(250, 3), ("kernel", "void b(int)", 255.0, 5.0, 3),
    launch(520, 4), ("kernel", "void c(int)", 600.0, 100.0, 4),
    launch(950, 5), ("kernel", "void d(int)", 960.0, 10.0, 5))
# two training steps; the backward's second launch (corr 5) stands for
# one on autograd's thread: inside orp.train.backward in time alone
TRAIN_PROGRAM = events(
    *ranges("orp.train.step", (0, 900), (1000, 1900)),
    *ranges("orp.train.to_device", (10, 50), (1010, 1040)),
    *ranges("orp.forward", (55, 100), (1050, 1100)),
    *ranges("orp.loss", (100, 500), (1100, 1400)),
    *ranges("orp.loss.assign", (100, 200), (1100, 1180)),
    *ranges("orp.loss.apaa", (200, 300), (1180, 1300)),
    *ranges("orp.loss.terms", (300, 500), (1300, 1400)),
    *ranges("orp.train.backward", (500, 700), (1400, 1600)),
    *ranges("orp.train.optimizer", (700, 850), (1600, 1800)))
# (the forward's kernel, corr 7, runs beside the batch's copy)
TRAIN = events(
    ("user_annotation", "pb.window", 0.0, 2000.0, None),
    ("cpu_op", "aten::copy_", 15.0, 10.0, None),
    ("cpu_op", "aten::mul", 140.0, 20.0, None),
    launch(20, 1), ("gpu_memcpy", "Memcpy HtoD", 60.0, 20.0, 1),
    launch(58, 7), ("kernel", "void fwd(int)", 62.0, 16.0, 7),
    launch(150, 2), ("kernel", "void mar_kernel<4>(float*)", 150.0, 10.0, 2),
    launch(250, 3), ("kernel", "void e(int)", 300.0, 10.0, 3),
    launch(600, 4), ("kernel", "void f(int)", 610.0, 200.0, 4),
    launch(1450, 5), ("kernel", "void g(int)", 1450.0, 100.0, 5),
    launch(1350, 6), ("kernel", "void h(int)", 1560.0, 10.0, 6))

# metric -> (trace, value a batch or step, worked out by hand)
EXPECTED = {
    "prepare_idle_ms.serve": ("serve", 1e-3 * (150 + 340) / 2),
    "fetch_ms.serve": ("serve", 1e-3 * (80 + 80) / 2),
    "results_ms.serve": ("serve", 1e-3 * (15 + 15) / 2),
    "launches.serve": ("serve", 3 / 2),  # the memcpy is no kernel
    "to_device_ms.train": ("train", 1e-3 * (40 + 30) / 2),
    "backward_ms.train": ("train", 1e-3 * (200 + 100) / 2),
    "optimizer_ms.train": ("train", 1e-3 * (150 + 200) / 2),
    "loss_assign_ms.train": ("train", 1e-3 * (100 + 80) / 2),
    "loss_apaa_ms.train": ("train", 1e-3 * (100 + 120) / 2),
    "loss_terms_ms.train": ("train", 1e-3 * (200 + 100) / 2),
    "loss_launches.train": ("train", 3 / 2),
    "loss_idle_ms.train": ("train", 1e-3 * (70 + 140) / 2),  # h's gap 10
}
# the metrics that read the benchmark's own wrappers before the program
# had these spans: the same names, units and meaning
REPOINTED = {
    "prepare_ms.serve": ("serve", 1e-3 * (80 + 90) / 2),
    "forward_ms.serve": ("serve", 1e-3 * 80 / 2),
    "decode_ms.serve": ("serve", 1e-3 * 5 / 2),
    "forward_ms.train": ("train", 1e-3 * 16 / 2),
    "losses_ms.train": ("train", 1e-3 * (400 + 300) / 2),
}
TRACES = {"serve": (SERVE, SERVE_PROGRAM), "train": (TRAIN, TRAIN_PROGRAM)}


def readings(view):
    return {"device": view.device, "device_cats": view.device_cats,
            "launch_ts": view.launch_ts, "t": (view.t0, view.t1),
            "_ops": view._ops,
            "window_s": view.window_s(), "busy_s": view.busy_s(),
            "kernel_s": view.kernel_s(("mar_kernel", "void e"))}


@pytest.mark.parametrize("kind", sorted(TRACES))
def test_trace_view_reads_the_same_with_the_program_spans(kind):
    without, spans = TRACES[kind]
    view = trace.TraceView(without + spans)
    assert readings(view) == readings(trace.TraceView(without))
    assert sorted(view.program) == sorted({e["name"] for e in spans})
    # the breakdown names the innermost span of each op's launch
    ops = {k.split(":")[0] for k, _ in view.breakdown()["device_ops"]}
    assert ops <= set(view.program) | {"-"} and ops - {"-"}
    assert {k.split(":")[0] for k, _ in trace.TraceView(
        without).breakdown()["device_ops"]} == {"-"}


def test_the_harness_builds_the_view_that_keeps_the_program_spans():
    import torch

    box = []
    with trace.profiled(box):
        with profiling.annotate("orp.forward"):
            torch.ones(4).add_(1)
    view = box[0]
    assert isinstance(view, trace.TraceView)
    assert len(view.program["orp.forward"]) == 1
    assert view.t0 < view.program["orp.forward"][0][0] < view.t1


def run_of(kind, with_program=True):
    without, spans = TRACES[kind]
    view = trace.TraceView(without + (spans if with_program else []))
    return types.SimpleNamespace(view=view, steps=2)


@pytest.mark.parametrize("name", sorted(EXPECTED) + sorted(REPOINTED))
def test_reader_gives_its_hand_computed_value(name):
    kind, want = {**EXPECTED, **REPOINTED}[name]
    reader = main.load_metric(name)
    assert reader.WRAPS == []
    assert reader.read(run_of(kind)) == pytest.approx(want, rel=1e-12)
    assert reader.read(run_of(kind, with_program=False)) is None


def test_every_program_span_reads_as_a_whole():
    view = run_of("train").view
    assert program_spans.device_s(view, None) == pytest.approx(366e-6)
    assert program_spans.host_s(view, None) == pytest.approx(1800e-6)
    gaps = program_spans.gaps(view)
    assert sum(s for s, _ in gaps) == pytest.approx((60 + 70 + 140 + 300
                                                     + 640) * 1e-6)
    assert program_spans.idle_s(view, None) == pytest.approx(
        sum(s for s, _ in gaps))


def reader_spans(path):
    return set(re.findall(r'"(orp\.[a-z_.]+)"', path.read_text()))


READERS = sorted(p for p in (BENCH / "metrics").glob("*.py")
                 if "program_spans" in p.read_text())


@pytest.mark.parametrize("path", READERS, ids=lambda p: p.stem)
def test_reader_reads_a_span_the_program_opens(path):
    spans = reader_spans(path)
    assert spans and spans <= set(profiling.SPANS)


def test_each_new_metric_is_declared_with_its_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    assert {p.stem for p in READERS} == set(EXPECTED) | set(REPOINTED)
    for name in EXPECTED:
        m = declared[name]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        kind = EXPECTED[name][0]
        assert m["workloads"] == [w["name"] for w in bench["workloads"]
                                  if f"-{kind}" in w["name"]]
