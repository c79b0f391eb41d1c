"""A tiny copy of the benchmark (narrow widths, 96^2 serving and 128^2
training canvases, a few images) written under a temporary root, for the
CPU tests."""

from __future__ import annotations

import json
from pathlib import Path

from port_bench.reference import detector

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def tiny_config(path: Path) -> dict:
    """A configuration's benchmark file, narrowed: the backbone by its
    reference module's own tiny(), the neck and head to 32 channels, small
    canvases and caps, float32."""
    conf = json.loads(path.read_text())
    cfg = conf["config"]
    detector.backbone_module(cfg).tiny(cfg)
    m = cfg["model"]
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
         "test_cfg": {"pre_nms_cap": 64}}
TRAIN = {"kind": "train", "batch": 2, "canvas": 128, "extent": [64, 128],
         "gts": [2, 8], "long_side": [8, 48], "aspect": [1, 4], "classes": 15,
         "pool_batches": 3, "check_steps": 2, "trace_steps": 1,
         "log_interval": 2, "reference_chunk": 1, "rate_seconds": 0.1}
TINY = {"serve": SERVE, "train": TRAIN}


def make_root(tmp: Path, limits: dict | None = None,
              src: Path = ROOT) -> Path:
    """tmp/BENCHMARK.json with the cells of src/BENCHMARK.json over tiny
    configs and mixes (each mix its real one's weight rules), and limits
    (default: the real ones)."""
    bench = json.loads((src / "BENCHMARK.json").read_text())
    base = src / BENCH.name
    for d in ("configs", "traffic", "limits"):
        (tmp / BENCH.name / d).mkdir(parents=True, exist_ok=True)
    for c in bench["configs"]:
        (tmp / c["file"]).write_text(json.dumps(tiny_config(src / c["file"])))
    for w in bench["workloads"]:
        real = json.loads((base / "traffic" / f"{w['traffic']}.json")
                          .read_text())
        mix = dict(TINY[real["kind"]], weights=real["weights"])
        (tmp / BENCH.name / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(mix))
        lim_file = base / "limits" / f"{w['name']}.json"
        lim = limits if limits is not None else (
            json.loads(lim_file.read_text()) if lim_file.exists() else {})
        (tmp / BENCH.name / "limits" / f"{w['name']}.json").write_text(
            json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
