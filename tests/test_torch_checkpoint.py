"""The port's checkpoints and its training CLIs, on the CPU.

A narrow copy of configs/dota/synth_r18_512.py (R-18, FPN and head width
32, canvas 128^2, float32) on tiles of two 256^2 scenes rendered by the
port.  Checked: a resumed run equals an uninterrupted one bit for bit;
loading is strict; tools/synth_benchmark_torch.py --train and
tools/train_torch.py (then --resume_from) run end to end.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.utils import checkpoint


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "configs/dota/synth_r18_512.py")
WIDTH = 32


def narrow_config_text(data_root: str) -> str:
    """synth_r18_512.py at width 32, canvas 128^2, float32, its data under
    data_root."""
    with open(SYNTH) as f:
        text = f.read()
    for a, b in [("out_channels=256", f"out_channels={WIDTH}"),
                 ("in_channels=256", f"in_channels={WIDTH}"),
                 ("feat_channels=256", f"feat_channels={WIDTH}"),
                 ("img_scale=(512, 512)", "img_scale=(128, 128)"),
                 ("canvas_buckets=[(512, 512)]",
                  "canvas_buckets=[(128, 128)]"),
                 ('compute_dtype="bfloat16"', 'compute_dtype="float32"'),
                 ('data_root = "work_dirs/synth_dota/"',
                  f'data_root = "{data_root}/"')]:
        assert a in text, a
        text = text.replace(a, b)
    return text


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two 256^2 train scenes and one val scene, cut into 128^2 tiles at
    gap 64, and the narrow config over them."""
    root = tmp_path_factory.mktemp("ckpt")
    for split, n, seed, prefix, name in (("train", 2, 0, "T", "train.json"),
                                         ("val", 1, 10_000, "V", "test.json")):
        generate_synth_dota(str(root / f"{split}_raw"), n, size=256,
                            seed=seed, prefix=prefix)
        ImgSplit(str(root / f"{split}_raw"), str(root / f"{split}_split"),
                 gap=64, subsize=128, ext=".npy", num_process=1).splitdata()
        dota2coco_train(str(root / f"{split}_split"),
                        str(root / f"{split}_split" / name), ext=".npy")
    (root / "narrow.py").write_text(narrow_config_text(str(root)))
    cfg = load_config(str(root / "narrow.py"))
    return root, cfg


def trainer(cfg, ds):
    model = apis.build_detector(cfg, "float32")
    model.init_weights(torch.Generator().manual_seed(0))
    loader = apis.build_dataloader(ds, cfg, batch_size=2)
    optimizer, scheduler, step = apis.build_trainer(model, cfg, len(loader))
    return model, optimizer, scheduler, step, loader


def state(model, optimizer, scheduler):
    momentum = [optimizer.state[p]["momentum_buffer"].clone()
                for g in optimizer.param_groups for p in g["params"]]
    return ({k: v.clone() for k, v in model.state_dict().items()}, momentum,
            scheduler.get_last_lr(), scheduler.last_epoch)


def test_resume_equals_an_uninterrupted_run(data, tmp_path):
    """3 steps straight == 2 steps, save, load into a fresh model,
    optimizer and scheduler, 1 step: parameters, momentum buffers, LR and
    step bit for bit."""
    root, cfg = data
    ds = apis.build_dataset(cfg["data"]["train"])
    model, opt, sched, step, loader = trainer(cfg, ds)
    batches = []
    for b in loader:
        batches.append(b)
        if len(batches) == 3:
            break
    for b in batches:
        losses = step(b)
    assert float(losses["num_pos"]) > 0
    straight = state(model, opt, sched)

    model, opt, sched, step, _ = trainer(cfg, ds)
    for b in batches[:2]:
        step(b)
    path = checkpoint.save_checkpoint(str(tmp_path), 1, model, opt, sched, 2,
                                      dict(classes=list(ds.CLASSES)))
    assert os.listdir(tmp_path) == ["epoch_1.pt"]  # no temporary left
    model, opt, sched, step, _ = trainer(cfg, ds)
    it, meta = checkpoint.load_checkpoint(str(tmp_path), model, opt, sched)
    assert (it, meta["epoch"], meta["classes"]) == (2, 1, list(ds.CLASSES))
    step(batches[2])
    resumed = state(model, opt, sched)
    assert straight[0].keys() == resumed[0].keys()
    for k in straight[0]:
        assert torch.equal(straight[0][k], resumed[0][k]), k
    assert len(straight[1]) == len(resumed[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(straight[1], resumed[1]))
    assert straight[2:] == resumed[2:] and resumed[3] == 3

    # the weights alone, for inference
    fresh = apis.build_detector(cfg, "float32")
    assert checkpoint.load_eval_variables(path, fresh)["epoch"] == 1


def test_loading_is_strict(data, tmp_path):
    root, cfg = data
    ds = apis.build_dataset(cfg["data"]["train"])
    model, opt, sched, _, _ = trainer(cfg, ds)
    for epoch in (3, 12):
        checkpoint.save_checkpoint(str(tmp_path), epoch, model, opt, sched,
                                   epoch * 9)
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith("epoch_12.pt")
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    wide = dict(cfg, model=dict(cfg["model"], neck=dict(
        cfg["model"]["neck"], out_channels=64)))
    with pytest.raises(RuntimeError, match="size mismatch"):
        checkpoint.load_eval_variables(str(tmp_path), apis.build_detector(
            wide, "float32"))
    torch.save({"model": {}}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match="not a checkpoint"):
        checkpoint.load_eval_variables(str(tmp_path / "other.pt"), model)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_checkpoint(str(tmp_path / "none"), model, opt, sched)


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tool", ["train_torch", "synth_benchmark_torch"])
def test_training_clis_default_to_cuda(data, tmp_path, tool):
    """Without --device the tools ask for the card, and raise without one
    before they write anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    root, _ = data
    argv = ([str(root / "narrow.py"), "--work_dir", str(tmp_path / "w")]
            if tool == "train_torch"
            else ["--train", "--work_dir", str(tmp_path / "w")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_tool(tool).main(argv)
    assert not (tmp_path / "w").exists()


def run_tool(*args):
    res = subprocess.run([sys.executable, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode in (0, 1), res.stdout + res.stderr
    return res


def test_synth_benchmark_train_cli(data, tmp_path):
    """--train with 2 train scenes and --max_steps 2 writes a checkpoint
    and synth_eval.json and prints its JSON line (rc 1: below mAP 0.6)."""
    root, _ = data
    res = run_tool("tools/synth_benchmark_torch.py", "--config",
                   str(root / "narrow.py"), "--work_dir", str(tmp_path),
                   "--train", "--train_scenes", "2", "--val_scenes", "2",
                   "--scene_size", "256", "--subsize", "128", "--gap", "64",
                   "--max_steps", "2", "--device", "cpu")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["train"]["steps"] == 2 and out["device"] == "cpu"
    assert set(out["per_class_ap"]) == {
        "plane", "bridge", "small-vehicle", "large-vehicle", "ship",
        "storage-tank"}
    assert res.returncode == (0 if out["mAP"] > 0.6 else 1)
    assert json.loads((tmp_path / "synth_eval.json").read_text()) == out
    assert os.listdir(tmp_path / "ckpts") == ["epoch_1.pt"]


def test_train_cli_and_resume(data, tmp_path):
    root, _ = data
    args = ("tools/train_torch.py", str(root / "narrow.py"), "--work_dir",
            str(tmp_path), "--device", "cpu", "--log_interval", "1")
    first = run_tool(*args, "--max_iters", "2", "--validate",
                     "--val_max_images", "2")
    assert first.returncode == 0
    assert "epoch 0 val mAP" in first.stdout
    assert os.listdir(tmp_path / "ckpts") == ["epoch_1.pt"]
    second = run_tool(*args, "--max_iters", "3", "--resume_from",
                      str(tmp_path / "ckpts"))
    assert second.returncode == 0
    assert "resumed from" in second.stdout
    assert "epoch 1 iter 2" in second.stdout
    assert "training finished at iter 3" in second.stdout
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["epoch_1.pt",
                                                      "epoch_2.pt"]
    assert np.isfinite(json.loads(
        second.stdout.split("epoch 1 iter 2 ")[1].splitlines()[0])[
            "loss_total"])
