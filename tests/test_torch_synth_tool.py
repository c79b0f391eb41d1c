"""tools/synth_benchmark_torch.py's --hard, --hrsc, --flip_tta and --ms_tta
on the CPU, run as a user runs it (a subprocess from the repo root).

A narrow copy of configs/dota/synth_r18_512_hard.py (widths 32, canvas
128^2, float32; its test_cfg cut to 64 candidates an image, so that the
plain NMS stays quick on the CPU) scores 256^2 scenes cut into 128^2
tiles, with seeded weights whose cls_out bias passes score_thr (random
weights detect nothing).  The JSON line carries the JAX tool's keys
(tools/synth_benchmark.py:387-415), the TTA pass's among them.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from orientedreppoints_tpu_torch import apis


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARD = os.path.join(REPO, "configs/dota/synth_r18_512_hard.py")
JAX_KEYS = {"metric", "mAP", "mAOE_deg", "per_class_ap", "per_class_aoe",
            "mAOE_mod90_deg", "per_class_aoe_mod90"}
JAX_TTA_KEYS = {"augs", "mAP", "mAOE_deg", "per_class_ap", "mAOE_mod90_deg"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The narrow config and a seeded state dict of it."""
    root = tmp_path_factory.mktemp("tool")
    with open(HARD) as f:
        text = f.read()
    for a, b in [("out_channels=256", "out_channels=32"),
                 ("in_channels=256", "in_channels=32"),
                 ("feat_channels=256", "feat_channels=32"),
                 ("img_scale=(512, 512)", "img_scale=(128, 128)"),
                 ("canvas_buckets=[(512, 512)]",
                  "canvas_buckets=[(128, 128)]"),
                 ('compute_dtype="bfloat16"', 'compute_dtype="float32"'),
                 ("nms_pre=2000,", "nms_pre=64,\n    pre_nms_cap=64,"),
                 ("max_per_img=512", "max_per_img=32")]:
        assert a in text, a
        text = text.replace(a, b)
    (root / "narrow.py").write_text(text)
    model, _ = apis.init_detector(str(root / "narrow.py"), device="cpu",
                                  compute_dtype="float32", seed=0)
    sd = model.state_dict()
    gen = torch.Generator().manual_seed(0)
    sd["bbox_head.cls_out.bias"] = torch.rand(
        sd["bbox_head.cls_out.bias"].shape, generator=gen) * 3 - 4
    for name in ("pts_init_out", "pts_refine_out"):
        sd[f"bbox_head.{name}.weight"] *= 10
    torch.save(sd, root / "w.pt")
    return root


def run(setup, work_dir, *flags):
    res = subprocess.run(
        [sys.executable, "tools/synth_benchmark_torch.py", "--config",
         str(setup / "narrow.py"), "--work_dir", str(work_dir),
         "--state_dict", str(setup / "w.pt"), "--val_scenes", "2",
         "--scene_size", "256", "--subsize", "128", "--gap", "64",
         "--device", "cpu", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        # one thread: beside the suite's other workers, torch's default
        # thread pool oversubscribes the cores (~100 s a run, ~7 s alone)
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode in (0, 1), res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert res.returncode == (0 if out["mAP"] > 0.6 else 1)
    assert json.loads((work_dir / "synth_eval.json").read_text()) == out
    return out


def merged_dets(folder) -> int:
    return sum(open(os.path.join(folder, f)).read().count("\n")
               for f in os.listdir(folder))


def test_hard_with_flip_and_multiscale_tta(setup, tmp_path):
    out = run(setup, tmp_path, "--hard", "--flip_tta", "--ms_tta", "0.5,1.0")
    assert JAX_KEYS <= set(out) and "hrsc_ap07" not in out
    assert out["metric"] == "synth_dota_hard_mAP"
    assert len(out["per_class_ap"]) == 15
    assert JAX_TTA_KEYS <= set(out["tta"])
    assert out["tta"]["augs"] == [[0.5, False], [0.5, True], [1.0, False],
                                  [1.0, True]]
    assert out["tta_mAP_delta"] == round(out["tta"]["mAP"] - out["mAP"], 4)
    assert merged_dets(tmp_path / "task1_merged") > 0
    assert merged_dets(tmp_path / "task1_merged_tta") > 0
    labels = (tmp_path / "val_raw" / "labelTxt" / "V0000.txt").read_text()
    assert any(c in labels for c in ("harbor", "helicopter", "roundabout"))


def test_hrsc_ship_scenes(setup, tmp_path):
    out = run(setup, tmp_path, "--hrsc", "--flip_tta")
    assert JAX_KEYS | {"hrsc_ap07"} <= set(out)
    assert out["metric"] == "synth_hrsc_mAP"
    assert list(out["per_class_ap"]) == ["ship"]
    assert 0.0 <= out["hrsc_ap07"] <= 1.0
    assert out["tta"]["augs"] == [[1.0, False], [1.0, True]]
    for name in os.listdir(tmp_path / "val_raw" / "labelTxt"):
        lines = (tmp_path / "val_raw" / "labelTxt" / name).read_text()
        assert lines.count(" ship 0\n") == lines.count("\n") > 0
