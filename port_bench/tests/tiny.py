"""A tiny copy of the benchmark (narrow widths, 96^2 serving and 128^2
training canvases, a few images) written under a temporary root, for the
CPU tests."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def tiny_config(name: str) -> dict:
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = conf["config"]
    m = cfg["model"]
    if m["backbone"]["type"] == "ResNet":
        m["backbone"]["depth"] = 18
        m["neck"]["in_channels"] = [64, 128, 256, 512]
    else:
        m["backbone"].update(embed_dim=32, depths=[2, 2, 2, 2],
                             num_heads=[1, 2, 4, 8])
        m["neck"]["in_channels"] = [64, 128, 256]
    m["neck"]["out_channels"] = 32
    m["bbox_head"].update(in_channels=32, feat_channels=32,
                          point_feat_channels=32)
    cfg["tpu"].update(canvas_buckets=[[128, 128]], max_gt=8, max_pos=64)
    for step in cfg["data"]["test"]["pipeline"]:
        if step["type"] == "RotateResize":
            step["img_scale"] = [128, 96]
    cfg["test_cfg"].update(nms_pre=50, max_per_img=40)
    conf["compute_dtype"] = "float32"
    return conf


SERVE = {"kind": "serve", "batch": 2, "image_hw": [80, 80], "canvas": 96,
         "pool_images": 4, "warmup_calls": 1, "check_batches": 1,
         "check_within": 2, "trace_batches": 2, "top_compare": 10,
         "reference_chunk": 1, "rate_seconds": 0.1,
         "weights": {"cls_bias": [-2.0, 1.0], "points_scale": 30.0},
         "test_cfg": {"pre_nms_cap": 64}}
TRAIN = {"kind": "train", "batch": 2, "canvas": 128, "extent": [64, 128],
         "gts": [2, 8], "long_side": [8, 48], "aspect": [1, 4], "classes": 15,
         "pool_batches": 3, "check_steps": 2, "trace_steps": 1,
         "log_interval": 2, "reference_chunk": 1, "rate_seconds": 0.1,
         "weights": {"cls_bias": [-2.0, 1.0], "points_scale": 30.0}}


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """tmp/BENCHMARK.json with the real cells' names over tiny configs and
    mixes, and limits (default: the real ones)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    (tmp / "port_bench" / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "port_bench" / "traffic").mkdir(exist_ok=True)
    (tmp / "port_bench" / "limits").mkdir(exist_ok=True)
    for c in bench["configs"]:
        (tmp / c["file"]).write_text(json.dumps(tiny_config(c["name"])))
    for w in bench["workloads"]:
        mix = SERVE if w["traffic"].startswith("serve") else TRAIN
        (tmp / "port_bench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(mix))
        src = BENCH / "limits" / f"{w['name']}.json"
        lim = limits if limits is not None else (
            json.loads(src.read_text()) if src.exists() else {})
        (tmp / "port_bench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
