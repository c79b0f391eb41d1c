"""The frozen arithmetic: FLOPs an image against a count over the
reference, the kernels' least times on known shapes, the roofline share
and the trace reduction on a made-up trace."""

import importlib
import inspect
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.harness import program_spans, spans, trace
from port_bench.reference import detector
from port_bench.tests.tiny import BENCH, ROOT
from port_bench.yardstick import kernels, peaks, roofline


def frozen_counts(root: Path = ROOT):
    """(config file, kind, canvas) of every frozen count of every
    configuration of root/BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        conf = json.loads((root / c["file"]).read_text())
        for kind, by_canvas in conf["flops_per_image"].items():
            for side in by_canvas:
                yield c["file"], kind, int(side)


def count_flops(cfg: dict, kind: str, side: int) -> int:
    """FLOPs of one image at side^2 over the reference, on the meta
    device: the forward (serve), or forward and backward of the trainable
    parameters (train)."""
    p = {n: torch.empty(s, device="meta").requires_grad_(
        detector.trainable(cfg, n)) for n, s, _ in detector.spec(cfg)}
    x = torch.empty(1, side, side, 3, device="meta")
    if kind == "serve":
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            detector.forward(p, x, cfg)
    else:
        key = (np.zeros(2, np.uint32), 0, 1)
        with FlopCounterMode(display=False) as fc:
            outs = detector.forward(p, x, cfg, key=key, train=True)
            sum(o.sum() for k in ("cls_scores", "pts_init", "pts_refine")
                for o in outs[k]).backward()
    return fc.get_total_flops()


def frozen_equals_count(root: Path, file: str, kind: str, side: int):
    conf = json.loads((root / file).read_text())
    assert count_flops(conf["config"], kind, side) == \
        conf["flops_per_image"][kind][str(side)]


def every_cell_counted(root: Path):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    counted = set(frozen_counts(root))
    for w in bench["workloads"]:
        mix = json.loads((root / BENCH.name / "traffic" /
                          f"{w['traffic']}.json").read_text())
        assert (files[w["config"]], mix["kind"], mix["canvas"]) in counted


@pytest.mark.parametrize("file,kind,side", [
    pytest.param(f, k, s, id=f"{Path(f).stem}-{k}-{s}")
    for f, k, s in frozen_counts()])
def test_frozen_flops_equal_a_count_over_the_reference(file, kind, side):
    frozen_equals_count(ROOT, file, kind, side)


def test_every_cell_has_its_frozen_count():
    every_cell_counted(ROOT)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_mfu_reads_the_untraced_rate_at_the_mix_canvas(kind):
    from port_bench.harness.main import load_metric

    reader = load_metric(f"mfu.{kind}")
    conf = {"flops_per_image": {kind: {"1024": 4.0e11}}}
    run = types.SimpleNamespace(conf=conf, kind=kind, canvas=1024,
                                rate=100.0, window_s=9.0, items=1)
    assert reader.read(run) == pytest.approx(100 * 4.0e13 / peaks.BF16_FLOPS)
    run.canvas = 1344
    assert reader.read(run) is None


def t(*shape, elem=4):
    return ("tensor", shape, elem)


def test_least_times_on_known_shapes():
    hbm = peaks.HBM_BYTES
    # 1000 point sets: 72 kB in, 32 + 72 + 4 kB out
    assert roofline.min_area_rect(t(1000, 18)) == pytest.approx(
        (72e3 + 104e3 + 4e3) / hbm)
    # 2 images x 128 quads: 8 kB + 8 B in, 2 x 128 x 2 words out
    full = ("values", torch.tensor([128, 128], dtype=torch.int32))
    assert roofline.quad_over_mask(t(2, 128, 8), 0.4, full) == \
        pytest.approx((8192 + 8 + 4096) / hbm)
    assert roofline.greedy_scan(t(2, 128, 2, elem=8), t(2, 128, elem=1),
                                full) == pytest.approx(
        (4096 + 256 + 8 + 256) / hbm)
    assert roofline.hull_quad_iou(t(1, 10, 9, 2), t(1, 10), t(1, 3, 8),
                                  t(1, 3, elem=1), t(1, 10, elem=1)) == \
        pytest.approx((720 + 40 + 96 + 3 + 10 + 120) / hbm)
    # the DCN forward at bf16, C 256, K 9: bytes bound
    rows = 1000
    fwd = roofline.deform_sample_pair(t(rows, 256, elem=2),
                                      t(rows, 256, elem=2),
                                      t(rows, 18, elem=2), [], 3)
    nbytes = 2 * rows * 256 * 2 + rows * 36 + 2 * rows * 9 * 256 * 2
    assert fwd == pytest.approx(nbytes / hbm)
    assert nbytes / hbm > rows * 9 * (30 + 14 * 256) / peaks.FP32_OPS
    bwd = roofline.deform_sample_pair_backward(
        t(rows, 256, elem=2), t(rows, 256, elem=2), t(rows, 18, elem=2),
        t(rows, 2304), t(rows, 2304), [], 3)
    nbytes = (2 * rows * 256 * 2 + rows * 36 + 2 * rows * 2304 * 4
              + 2 * rows * 256 * 4 + rows * 36)
    assert bwd == pytest.approx(nbytes / hbm)


def test_decode_least_times_count_the_valid_prefix():
    hbm = peaks.HBM_BYTES
    # 2 images of 4096 candidates, 200 and 0 valid: 200 quads in, 200
    # rows x 4 words out; the scan reads those words
    few = ("values", torch.tensor([200, 0], dtype=torch.int32))
    assert roofline.quad_over_mask(t(2, 4096, 8), 0.4, few) == \
        pytest.approx((200 * 32 + 8 + 200 * 4 * 8) / hbm)
    assert roofline.greedy_scan(t(2, 4096, 64, elem=8), t(2, 4096, elem=1),
                                few) == pytest.approx(
        (200 * 4 * 8 + 8192 + 8 + 8192) / hbm)
    # a count an image is recorded as the tensor, read after the window,
    # where the kernel table names the argument; every other tensor, small
    # integer ones too, by its shape
    rec = spans.Recorder()
    rec.on = True
    nv = torch.tensor([200, 0], dtype=torch.int32)

    def launcher(quads, iou_thr, num_valid):
        return None

    spans._wrap(launcher, "k", rec, ("num_valid",))(
        torch.zeros(2, 4096, 8), 0.4, nv)
    spans._wrap(launcher, "k", rec, ("num_valid",))(
        torch.zeros(2, 4096, 8), 0.4, num_valid=nv)
    spans._wrap(launcher, "j", rec)(torch.zeros(2, 4096, 8), 0.4, nv)
    (quads, thr, counts), _ = rec.calls["k"][0]
    assert quads == t(2, 4096, 8) and thr == 0.4
    assert counts[0] == "values" and counts[1] is nv
    assert rec.calls["k"][1][1]["num_valid"][1] is nv
    assert rec.calls["j"][0][0][2] == t(2, elem=4)


def test_by_value_arguments_are_the_launchers_own(monkeypatch):
    for name, (module, attr, _, _, by_value) in kernels.KERNELS.items():
        fn = getattr(importlib.import_module(module), attr)
        assert set(by_value) <= set(inspect.signature(fn).parameters), name
    assert kernels.KERNELS["quad_over_mask"][4] == ("num_valid",)
    assert kernels.KERNELS["nms_scan"][4] == ("num_valid",)
    # a launcher whose named argument is gone is skipped, as a missing one
    mod = types.ModuleType("renamed")
    mod.launch = lambda quads, iou_thr: None
    monkeypatch.setitem(sys.modules, "renamed", mod)
    launch = mod.launch
    spans.install([("renamed", "launch", "k", ("num_valid",))],
                  spans.Recorder())
    assert mod.launch is launch


def test_convex_giou_least_time_on_known_shapes():
    hbm = peaks.HBM_BYTES
    # 1000 rows: 72 + 32 kB in, 4 kB of GIoU out
    assert roofline.convex_giou(t(1000, 18), t(1000, 8)) == pytest.approx(
        (72e3 + 32e3 + 4e3) / hbm)
    # with the weights: 4 kB more in, 72 kB of gradient more out
    assert roofline.convex_giou(t(1000, 18), t(1000, 8), t(1000)) == \
        pytest.approx((72e3 + 32e3 + 4e3 + 4e3 + 72e3) / hbm)
    # the launcher whose calls are recorded, and its kernel in the trace
    module, attr, fn, patterns, by_value = kernels.KERNELS["convex_giou"]
    assert (module, attr) == ("orientedreppoints_tpu_torch.ops.giou",
                              "convex_giou_kernel")
    assert fn is roofline.convex_giou and patterns == ("convex_giou_kernel",)
    assert by_value == ()


def events(*evs):
    out = []
    for cat, name, ts, dur, corr in evs:
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        out.append(e)
    return out


VIEW = trace.TraceView(events(
    ("user_annotation", "pb.window", 0.0, 1000.0, None),
    ("user_annotation", "orp.forward", 10.0, 300.0, None),
    ("cpu_op", "aten::conv2d", 20.0, 50.0, None),
    ("cuda_runtime", "cudaLaunchKernel", 30.0, 5.0, 1),
    ("cuda_runtime", "cudaLaunchKernel", 400.0, 5.0, 2),
    ("kernel", "void mar_kernel<4>(float*)", 100.0, 200.0, 1),
    ("kernel", "void other(int)", 250.0, 150.0, 2)))


def test_trace_reduction():
    assert VIEW.window_s() == pytest.approx(1e-3)
    assert VIEW.busy_s() == pytest.approx(300e-6)  # union of 100-400
    assert program_spans.device_s(VIEW, "orp.forward") == pytest.approx(
        200e-6)
    assert VIEW.kernel_s(("mar_kernel",)) == pytest.approx(200e-6)
    br = VIEW.breakdown()
    assert br["device_ops"][0] == ("orp.forward:mar_kernel",
                                   pytest.approx(2e-4))
    assert br["device_ops"][1] == ("-:other", pytest.approx(1.5e-4))
    gaps = dict(br["idle_gaps"])
    assert gaps["orp.forward:aten::conv2d"] == pytest.approx(100e-6)
    assert gaps["-:after last device op"] == pytest.approx(600e-6)


def test_roofline_share_and_nothing_to_read():
    rec = spans.Recorder()
    rec.calls["k.min_area_rect"].append(([t(1000, 18)], {}))
    run = types.SimpleNamespace(view=VIEW, rec=rec)
    share = kernels.roofline_share(run, ["min_area_rect"])
    assert share == pytest.approx(100 * roofline.min_area_rect(
        t(1000, 18)) / 200e-6)
    assert kernels.roofline_share(run, ["nms_scan"]) is None
