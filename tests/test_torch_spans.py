"""The port's spans (utils/profiling.annotate and SPANS) on the CPU: a
Predictor call and a training step under utils/profiling.trace hold every
documented orp.* range once a batch or a step, each inside its parent's
interval, the three loss ranges tiling orp.loss; the results are the same
bit for bit with a profiler on and off; with none on, annotate makes no
record_function; the exported inference program holds no profiler op."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from orientedreppoints_tpu_torch.core.loss_head import LossConfig
from orientedreppoints_tpu_torch.parallel import train
from orientedreppoints_tpu_torch.serving import Predictor
from orientedreppoints_tpu_torch.utils import profiling

CFG = dict(
    model=dict(backbone=dict(type="ResNet", depth=18),
               neck=dict(out_channels=32, num_outs=5),
               bbox_head=dict(num_classes=16, feat_channels=32,
                              point_feat_channels=32)),
    test_cfg=dict(nms_pre=50, score_thr=0.0, nms=dict(iou_thr=0.4),
                  max_per_img=20, pre_nms_cap=64),
    img_norm_cfg=dict(mean=[100.0, 110.0, 120.0], std=[50.0, 55.0, 60.0],
                      to_rgb=True),
    data=dict(test=dict(pipeline=[dict(type="RotateResize",
                                       img_scale=(64, 64))])),
    tpu=dict(canvas_buckets=[(64, 64)]),
)
SERVE_SPANS = {"orp.serve.call", "orp.serve.prepare", "orp.forward",
               "orp.decode", "orp.serve.fetch", "orp.serve.results"}
TRAIN_SPANS = {"orp.train.step", "orp.train.to_device",
               "orp.train.normalize", "orp.forward", "orp.loss",
               "orp.loss.assign", "orp.loss.apaa", "orp.loss.terms",
               "orp.train.backward", "orp.train.optimizer"}
# each span -> the span that encloses it
SERVE_PARENT = {"orp.serve.prepare": "orp.serve.call",
                "orp.forward": "orp.serve.call",
                "orp.decode": "orp.serve.call",
                "orp.serve.fetch": "orp.serve.call",
                "orp.serve.results": "orp.serve.call"}
TRAIN_PARENT = {"orp.train.to_device": "orp.train.step",
                "orp.train.normalize": "orp.train.step",
                "orp.forward": "orp.train.step",
                "orp.loss": "orp.train.step",
                "orp.loss.assign": "orp.loss",
                "orp.loss.apaa": "orp.loss",
                "orp.loss.terms": "orp.loss",
                "orp.train.backward": "orp.train.step",
                "orp.train.optimizer": "orp.train.step"}
LOSS_PARTS = ("orp.loss.assign", "orp.loss.apaa", "orp.loss.terms")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(n):
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (50 + 4 * i, 64, 3), dtype=np.uint8)
            for i in range(n)]


def batch():
    rng = np.random.default_rng(6)
    quad = np.float32([[10, 10, 40, 12, 38, 30, 9, 28],
                       [30, 34, 60, 36, 58, 56, 29, 54]])
    return dict(images=rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
                gt_polys=np.stack([quad, quad[::-1]]),
                gt_labels=np.int32([[3, 7], [4, 1]]),
                gt_valid=np.ones((2, 2), bool),
                img_hw=np.int32([[64, 64], [64, 48]]))


def trainer(model):
    train.freeze(model, train.default_frozen_prefixes(1))
    opt, sched = train.build_optimizer(model, train.lr_schedule())
    norm = {k: CFG["img_norm_cfg"][k] for k in ("mean", "std", "to_rgb")}
    return train.make_train_step(model, LossConfig(max_pos=16), opt, sched,
                                 img_norm=norm)


def traced(fn, tmp_path):
    """fn() under profiling.trace -> (its result, {span: [(start, end)]})
    of the orp.* ranges in the written trace."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith("orp.")):
            ts = float(e["ts"])
            spans.setdefault(e["name"], []).append(
                (ts, ts + float(e.get("dur", 0.0))))
    return out, {k: sorted(v) for k, v in spans.items()}


def assert_nested(spans, parent_of):
    for child, parent in parent_of.items():
        for a, b in spans[child]:
            assert any(pa <= a and b <= pb for pa, pb in spans[parent]), \
                (child, parent)


@pytest.fixture(scope="module")
def predictor():
    return Predictor(CFG, batch_size=2, compute_dtype="float32",
                     device="cpu")


def test_serving_call_holds_each_span_once_a_batch(predictor, tmp_path):
    _, spans = traced(lambda: predictor(images(4)), tmp_path)  # 2 chunks
    assert set(spans) == SERVE_SPANS
    assert {k: len(v) for k, v in spans.items()} == dict.fromkeys(
        SERVE_SPANS, 2)
    assert_nested(spans, SERVE_PARENT)


def test_train_step_holds_each_span_once_a_step(predictor, tmp_path):
    step = trainer(copy.deepcopy(predictor.model))

    def two_steps():
        step(batch())
        step(batch())
    _, spans = traced(two_steps, tmp_path)
    assert set(spans) == TRAIN_SPANS
    assert {k: len(v) for k, v in spans.items()} == dict.fromkeys(
        TRAIN_SPANS, 2)
    assert_nested(spans, TRAIN_PARENT)
    # the loss's three ranges follow one another inside it
    for i in range(2):
        parts = [spans[k][i] for k in LOSS_PARTS]
        for (_, end), (start, _) in zip(parts, parts[1:]):
            assert end <= start


def test_every_span_is_documented():
    assert set(profiling.SPANS) == SERVE_SPANS | TRAIN_SPANS


def test_spans_change_no_result(predictor, tmp_path):
    imgs = images(3)
    off = predictor(imgs)
    on, _ = traced(lambda: predictor(imgs), tmp_path / "serve")
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    models = [copy.deepcopy(predictor.model) for _ in range(2)]
    steps = [trainer(m) for m in models]
    loss_off = steps[0](batch())
    loss_on, _ = traced(lambda: steps[1](batch()), tmp_path / "train")
    assert loss_off.keys() == loss_on.keys()
    for k in loss_off:
        assert torch.equal(loss_off[k], loss_on[k]), k
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(p, q)


def test_annotate_off_makes_no_record_function(predictor, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    # annotate's own (torch's optimizer opens ranges of its own through
    # torch.autograd.profiler)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.annotate("orp.forward") is profiling.annotate("x")
    predictor(images(1))
    trainer(copy.deepcopy(predictor.model))(batch())


def test_span_rows_give_each_span_of_a_window(predictor, tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        predictor(images(2))
    rows = profiling.span_rows(prof.key_averages(), 1)
    assert [r.split()[:3] for r in rows] == [
        [name, "calls", "1"] for name in sorted(SERVE_SPANS)]
