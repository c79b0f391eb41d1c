"""The serving kernels as torch.library custom ops, and torch.export of the
inference graph through them (tools/export_model_torch.py), on the CPU.

torch.library.opcheck holds each op's schema, fake (meta) version and
dispatch on CPU inputs, where the op runs its plain version; a small R-18
config exported by the tool, saved and loaded, gives the eager model's
decode_detections outputs bit for bit, with the four serving ops kept whole
in the graph."""

import importlib.util
import os.path as osp

import numpy as np
import pytest
import torch

from orientedreppoints_tpu_torch import ops
from orientedreppoints_tpu_torch.ops import deform_conv, nms, quad_iou

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SERVING_OPS = ("min_area_rect", "quad_over_mask", "greedy_scan",
               "deform_sample_pair")
TINY = """
model = dict(backbone=dict(type="ResNet", depth=18),
             neck=dict(out_channels=32, num_outs=5),
             bbox_head=dict(num_classes=16, feat_channels=32,
                            point_feat_channels=32))
test_cfg = dict(nms_pre=60, score_thr=0.0, nms=dict(iou_thr=0.4),
                max_per_img=25, pre_nms_cap=96)
tpu = dict(compute_dtype="float32", canvas_buckets=[(64, 64), (96, 96)])
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def export_tool():
    spec = importlib.util.spec_from_file_location(
        "_export_model_torch",
        osp.join(REPO, "tools", "export_model_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def op_cases():
    rng = np.random.default_rng(0)
    pts = torch.from_numpy((rng.uniform(0, 50, (40, 1, 2))
                            + rng.normal(0, 4, (40, 9, 2))).reshape(40, 18)
                           .astype(np.float32))
    c = rng.uniform(0, 60, (2, 70, 1, 2))
    quads = torch.from_numpy((c + rng.uniform(-8, 8, (2, 70, 4, 2)))
                             .reshape(2, 70, 8).astype(np.float32))
    nv = torch.tensor([70, 41], dtype=torch.int32)
    mask = quad_iou.quad_over_mask(quads, 0.2, nv)
    valid = torch.arange(70)[None] < nv[:, None]
    shapes = [2, 4, 5, 2, 2, 3]  # two levels of (B, H, W)
    rows = 2 * 4 * 5 + 2 * 2 * 3
    table = torch.from_numpy(rng.normal(size=(rows, 8)).astype(np.float32))
    off = torch.from_numpy(rng.normal(0, 2, (rows, 18)).astype(np.float32))
    return {"min_area_rect": (pts,), "convex_hull": (pts,),
            "quad_over_mask": (quads, 0.2, nv),
            "greedy_scan": (mask, valid, nv),
            "deform_sample_pair": (table, table * 2, off, shapes, 3)}


@pytest.mark.parametrize("name", list(op_cases()))
def test_custom_op_passes_opcheck(name):
    args = op_cases()[name]
    op = getattr(torch.ops.orp, name).default
    torch.library.opcheck(op, args)


def test_entries_dispatch_to_the_ops_plain_versions():
    cases = op_cases()
    ops.reset_launch_counts()
    pts = cases["min_area_rect"][0]
    assert torch.equal(ops.minarearect.min_area_rect(pts),
                       ops.geometry.min_area_rect(pts))
    quads, thr, nv = cases["quad_over_mask"]
    assert torch.equal(quad_iou.quad_over_mask(quads, thr, nv),
                       quad_iou.quad_over_mask_plain(quads, thr, nv))
    mask, valid, nv = cases["greedy_scan"]
    assert torch.equal(nms.greedy_scan(mask, valid, nv),
                       nms.greedy_scan_plain(mask, valid, nv))
    t_a, t_b, off, flat, k = cases["deform_sample_pair"]
    shapes = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
    for got, want in zip(
            deform_conv.deform_sample_pair(t_a, t_b, off, shapes, k),
            deform_conv.deform_sample_pair_plain(t_a, t_b, off, shapes, k)):
        assert torch.equal(got, want)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_exported_program_equals_eager(tmp_path):
    from orientedreppoints_tpu_torch.apis import init_detector

    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text(TINY)
    tool = export_tool()
    out = tmp_path / "tiny.pt2"
    assert tool.main([str(cfg_path), str(out), "--batch", "2",
                      "--device", "cpu"]) == 0
    program = torch.export.load(str(out))
    targets = {str(n.target) for n in program.graph.nodes
               if n.op == "call_function"}
    for name in SERVING_OPS:
        assert f"orp.{name}.default" in targets, name
    # the same seeded weights, eager (score_thr 0: every candidate counts)
    model, cfg = init_detector(str(cfg_path), compute_dtype="float32",
                               device="cpu")
    eager = tool.inference_module(model, cfg["test_cfg"])
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 96, 96, 3)).astype(np.float32))
    with torch.no_grad():
        want = eager(x)
        got = program.module()(x)
    assert int(want[2].sum()) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
