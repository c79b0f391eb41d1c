"""The port's long-run re-exec (utils/chunked.py, --rss_limit_gb of both
training tools), the synthetic tool's --skip_train and the robustness
tool (tools/test_robustness_torch.py), on the CPU.

utils/chunked.py is held to the JAX module's behaviour with os.execv
monkeypatched.  The tools run as a user runs them (subprocesses from the
repo root, one torch thread) on a narrow copy of
configs/dota/synth_r18_512.py (R-18, widths 32, canvas 128^2, float32,
64 candidates an image) and one 128^2 scene (one tile, a step an
epoch): with --rss_limit_gb 0.001 every epoch boundary with epochs left
re-executes, and the checkpoint of the re-executed run equals an
uninterrupted run's bit for bit.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from orientedreppoints_tpu.utils import chunked as chunked_ref
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
from orientedreppoints_tpu_torch.utils import chunked

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "configs/dota/synth_r18_512.py")
SCENE = ["--scene_size", "128", "--subsize", "128", "--gap", "64"]
# tools/test_robustness.py's artifact
JAX_KEYS = {"metric", "P", "mPC", "rPC", "per_setting", "max_images"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def narrow_config_text(data_root: str) -> str:
    """synth_r18_512.py at width 32, canvas 128^2, float32, 64 candidates
    and 32 dets an image, its data under data_root."""
    with open(SYNTH) as f:
        text = f.read()
    for a, b in [("out_channels=256", "out_channels=32"),
                 ("in_channels=256", "in_channels=32"),
                 ("feat_channels=256", "feat_channels=32"),
                 ("img_scale=(512, 512)", "img_scale=(128, 128)"),
                 ("canvas_buckets=[(512, 512)]",
                  "canvas_buckets=[(128, 128)]"),
                 ('compute_dtype="bfloat16"', 'compute_dtype="float32"'),
                 ("nms_pre=2000,", "nms_pre=64,\n    pre_nms_cap=64,"),
                 ("max_per_img=512", "max_per_img=32"),
                 ('data_root = "work_dirs/synth_dota/"',
                  f'data_root = "{data_root}/"')]:
        assert a in text, a
        text = text.replace(a, b)
    return text


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """One 128^2 train scene and one val scene, each one 128^2 tile (the
    synthetic tool's work-dir layout), the narrow config over
    them and a seeded state dict whose cls_out bias passes score_thr."""
    root = tmp_path_factory.mktemp("chunked")
    for split, seed, prefix, name in (("train", 0, "T", "train.json"),
                                      ("val", 10_000, "V", "test.json")):
        generate_synth_dota(str(root / f"{split}_raw"), 1, size=128,
                            seed=seed, prefix=prefix)
        ImgSplit(str(root / f"{split}_raw"), str(root / f"{split}_split"),
                 gap=64, subsize=128, ext=".npy", num_process=1).splitdata()
        dota2coco_train(str(root / f"{split}_split"),
                        str(root / f"{split}_split" / name), ext=".npy")
    (root / "narrow.py").write_text(narrow_config_text(str(root)))
    model, _ = apis.init_detector(str(root / "narrow.py"), device="cpu",
                                  compute_dtype="float32", seed=0)
    sd = model.state_dict()
    gen = torch.Generator().manual_seed(0)
    sd["bbox_head.cls_out.bias"] = torch.rand(
        sd["bbox_head.cls_out.bias"].shape, generator=gen) * 3 - 4
    torch.save(sd, root / "w.pt")
    return root


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(*args, rcs=(0,)):
    res = subprocess.run([sys.executable, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode in rcs, res.stdout + res.stderr
    return res


@pytest.mark.parametrize("argv,ensure,ensure_kv", [
    (["t.py", "--train"], ["--resume", "--skip_gen"], None),
    (["t.py", "--resume", "--x", "1"], ["--resume", "--skip_gen"], None),
    (["t.py", "cfg"], [], {"--resume_from": "w/ckpts"}),
    (["t.py", "cfg", "--resume_from", "old"], [], {"--resume_from": "new"}),
    (["t.py", "cfg", "--resume_from"], [], {"--resume_from": "new"}),
    (["t.py"], ["--a"], {"--b": "1", "--c": "2"}),
])
def test_argv_with_flags_matches_jax(argv, ensure, ensure_kv):
    assert chunked.argv_with_flags(argv, ensure, ensure_kv) == \
        chunked_ref.argv_with_flags(argv, ensure, ensure_kv)


@pytest.mark.parametrize("limit", [None, 0, -1.0, 1e9, 1e-3])
def test_maybe_reexec_matches_jax(monkeypatch, limit):
    """Below the limit or disabled: nothing; past it: save_fn, then the
    log line and os.execv(python, [python] + the new argv), as JAX's."""
    monkeypatch.setattr(sys, "argv", ["tools/x.py", "--train"])
    calls = {}
    for mod in (chunked, chunked_ref):
        got = []
        monkeypatch.setattr(mod, "current_rss_gb", lambda: 0.5)
        monkeypatch.setattr(os, "execv",
                            lambda exe, argv: got.append(("exec", exe, argv)))
        mod.maybe_reexec(
            limit, lambda: got.append(("save",)),
            lambda argv: mod.argv_with_flags(argv, ensure=["--resume"]),
            log=lambda line: got.append(("log", line)))
        calls[mod] = got
    assert calls[chunked] == calls[chunked_ref]
    assert len(calls[chunked]) == (3 if limit == 1e-3 else 0)
    if calls[chunked]:
        assert calls[chunked][2] == ("exec", sys.executable, [
            sys.executable, "tools/x.py", "--train", "--resume"])


def test_current_rss_gb():
    rss = chunked.current_rss_gb()
    assert 0.01 < rss < 1e3
    assert abs(rss - chunked_ref.current_rss_gb()) < 0.5


def ckpt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_synth_tool_reexec_resume_and_skip_train(data, tmp_path, capsys):
    """--rss_limit_gb 0.001 --stop_epoch 2 (a subprocess): one re-exec
    with --resume --skip_gen after epoch 1 (its checkpoint saved first),
    exit 3; the epoch-2 checkpoint equals an uninterrupted run's bit for
    bit (model, momentum, scheduler, step); --skip_train then scores it
    as --state_dict scores its weights (both in this process)."""
    common = ["--config", str(data / "narrow.py"), "--train_scenes", "1",
              "--val_scenes", "1", *SCENE, "--device", "cpu"]
    train = ["--train", "--stop_epoch", "2"]
    a = run("tools/synth_benchmark_torch.py", *common, "--work_dir",
            str(tmp_path / "a"), *train, "--rss_limit_gb", "0.001",
            rcs=(3,))
    assert a.stdout.count("[chunked]") == 1
    assert "--resume --skip_gen" in a.stdout
    assert "resumed at epoch 1, step 1" in a.stdout
    assert "(rss " in a.stdout
    tool = load_tool("synth_benchmark_torch")
    with pytest.raises(SystemExit) as stop:
        tool.main(common + ["--work_dir", str(tmp_path / "b"), *train,
                            "--rss_limit_gb", "0"])
    assert stop.value.code == 3
    assert "[chunked]" not in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "a" / "ckpts")) == [
        "epoch_1.pt", "epoch_2.pt"]
    assert os.listdir(tmp_path / "b" / "ckpts") == ["epoch_2.pt"]
    ca = ckpt(tmp_path / "a" / "ckpts" / "epoch_2.pt")
    cb = ckpt(tmp_path / "b" / "ckpts" / "epoch_2.pt")
    assert ca["step"] == cb["step"] == 2
    for key in ("model", "optimizer", "scheduler", "step"):
        assert same_tree(ca[key], cb[key]), key

    scores = {}
    torch.save(ca["model"], tmp_path / "a.pt")
    for name, flags in (("skip", ["--skip_train"]),
                        ("plain", ["--state_dict", str(tmp_path / "a.pt")])):
        tool.main(common + ["--work_dir", str(tmp_path / "a"), "--skip_gen",
                            *flags])
        scores[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    out = scores["skip"]
    assert out["weights"].endswith("epoch_2.pt, epoch 2")
    assert out["train"] is None
    for k in ("mAP", "mAOE_deg", "per_class_ap", "per_class_aoe",
              "mAOE_mod90_deg"):
        assert out[k] == scores["plain"][k], k


def test_synth_tool_skip_train_refusals(tmp_path):
    tool = load_tool("synth_benchmark_torch")
    for flags in (["--train"], ["--state_dict", "w.pt"]):
        with pytest.raises(SystemExit, match="--skip_train"):
            tool.main(["--skip_train", *flags, "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        tool.main(["--skip_train", "--work_dir", str(tmp_path),
                   "--val_scenes", "1", "--scene_size", "128", "--subsize",
                   "128", "--device", "cpu"])


def test_train_tool_reexec(data, tmp_path):
    """tools/train_torch.py --total_epochs 2 --rss_limit_gb 0.001: one
    re-exec with --resume_from work_dir/ckpts, the run ends at iter 2."""
    res = run("tools/train_torch.py", str(data / "narrow.py"), "--work_dir",
              str(tmp_path), "--device", "cpu", "--total_epochs", "2",
              "--rss_limit_gb", "0.001", "--log_interval", "1")
    assert res.stdout.count("[chunked]") == 1
    assert f"--resume_from {tmp_path / 'ckpts'}" in res.stdout
    assert "resumed from" in res.stdout and "at epoch 1, iter 1" in res.stdout
    assert "training finished at iter 2" in res.stdout
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["epoch_1.pt",
                                                      "epoch_2.pt"]


def test_train_tool_refuses_rss_limit_in_a_group(data, tmp_path,
                                                 monkeypatch):
    """A data-parallel group does not re-exec: an explicit limit is
    refused before any training."""
    from orientedreppoints_tpu_torch.parallel import dist

    monkeypatch.setattr(dist, "init_from_env", lambda device: "group")
    monkeypatch.setattr(dist, "rank", lambda group: 0)
    monkeypatch.setattr(dist, "destroy", lambda group: None)
    with pytest.raises(SystemExit, match="data-parallel"):
        load_tool("train_torch").main([
            str(data / "narrow.py"), "--work_dir", str(tmp_path),
            "--device", "cpu", "--rss_limit_gb", "5"])
    assert not os.path.exists(tmp_path / "ckpts")


def test_robustness_tool(data, tmp_path, capsys):
    """Two corruptions at severity 3 over the val tiles: a line per
    setting, and the JSON line (and --out) with JAX's keys, its values by
    JAX's formula from the settings' own mAPs."""
    out_path = tmp_path / "robust.json"
    tool = load_tool("test_robustness_torch")
    assert tool.main([
        str(data / "narrow.py"), "--checkpoint", str(data / "w.pt"),
        "--data_root", str(data), "--corruptions", "gaussian_noise",
        "jpeg_compression", "--severities", "3", "--max_images", "4",
        "--device", "cpu"] + ["--out", str(out_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert set(out) == JAX_KEYS
    assert json.loads(out_path.read_text()) == out
    P = float(lines[0].split("mAP ")[1])
    maps = {f"{line.split()[0]}@3": float(line.split("mAP ")[1])
            for line in lines[1:3]}
    assert lines[0].startswith("clean baseline P: ")
    assert out["per_setting"] == {k: round(v, 4) for k, v in maps.items()}
    assert set(out["per_setting"]) == {"gaussian_noise@3",
                                       "jpeg_compression@3"}
    mPC = float(np.mean(list(out["per_setting"].values())))
    assert out["metric"] == "robustness_mPC" and out["max_images"] == 4
    assert out["P"] == round(P, 4) and out["mPC"] == round(mPC, 4)
    assert out["rPC"] == (round(mPC / P, 4) if P > 0 else 0.0)


def test_robustness_summary_formula():
    """JAX's tools/test_robustness.py arithmetic: mPC is the mean of the
    rounded settings, rPC divides by the unrounded P."""
    tool = load_tool("test_robustness_torch")
    per = {"a@1": 0.81234, "b@1": 0.5}
    out = tool.summary(0.912345, {k: round(v, 4) for k, v in per.items()},
                       36)
    assert out == {"metric": "robustness_mPC", "P": 0.9123, "mPC": 0.6562,
                   "rPC": round(0.65615 / 0.912345, 4),
                   "per_setting": {"a@1": 0.8123, "b@1": 0.5},
                   "max_images": 36}
    assert tool.summary(0.0, {}, 1)["rPC"] == 0.0
    with pytest.raises(SystemExit, match="severities"):
        tool.main(["cfg.py", "--severities", "0", "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown"):
        tool.main(["cfg.py", "--corruptions", "fog", "--device", "cpu"])
