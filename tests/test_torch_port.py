"""The PyTorch port's boundaries: it runs without JAX, flax, cv2 or PIL
(serving,
a train step, TTA, soft-NMS, the evaluation path, the training data
path: train pipeline, loader and checkpoint, Swin serving and an AdamW
step, the hard and ship-only scenes, the HRSC labels, dataset and
evaluators, the benchmark tool's modes, a batch of the hard-aug train
pipeline, a forward of HRNet, SSD-VGG and ResNeXt detectors, horizontal
NMS, the Task2 / UCAS-AOD evaluators, the IoU loss, collect_env,
profiling, the visual tools' drawing, the host polygon IoU, DropPath's
keys, and every tools/*_torch.py imported); the
train pipelines of every config with hard-aug
steps build; the R-50 demo model's flax tree converts completely;
CUDA-only entries raise without a GPU; CPU tensors never reach a
kernel."""

import os
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.utils import Config, builder
from orientedreppoints_tpu_torch import ops
from orientedreppoints_tpu_torch.apis import build_detector
from orientedreppoints_tpu_torch.data.pipelines import (MultiSamplePipeline,
                                                        build_pipeline)
from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.models.detector import decode_detections
from orientedreppoints_tpu_torch.ops import (deform_conv, hull_iou,
                                             minarearect, quad_iou)
from orientedreppoints_tpu_torch.serving import Predictor
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R50 = os.path.join(REPO, "configs/dota/orientedreppoints_r50_demo.py")

NO_JAX_SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "flax", "cv2", "PIL", "orientedreppoints_tpu"):
        sys.modules[name] = None  # import raises ImportError
    import numpy as np
    from orientedreppoints_tpu_torch.serving import Predictor
    cfg = dict(
        model=dict(backbone=dict(type="ResNet", depth=18),
                   neck=dict(out_channels=32, num_outs=5),
                   bbox_head=dict(num_classes=16, feat_channels=32,
                                  point_feat_channels=32)),
        test_cfg=dict(nms_pre=50, score_thr=0.0, nms=dict(iou_thr=0.4),
                      max_per_img=20, pre_nms_cap=64),
        img_norm_cfg=dict(mean=[0, 0, 0], std=[1, 1, 1], to_rgb=True),
        data=dict(test=dict(pipeline=[dict(type="RotateResize",
                                           img_scale=(64, 64))])),
        tpu=dict(canvas_buckets=[(64, 64)]),
    )
    pred = Predictor(cfg, batch_size=2, compute_dtype="float32",
                     device="cpu")
    out = pred([np.zeros((50, 64, 3), np.uint8)])
    assert len(out) == 1 and len(out[0]) == 15
    assert sum(len(a) for a in out[0]) > 0
    # the training step: losses, assigners, APAA, SGD
    from orientedreppoints_tpu_torch.core.loss_head import LossConfig
    from orientedreppoints_tpu_torch.parallel import train
    model = pred.model
    train.freeze(model, train.default_frozen_prefixes(1))
    opt, sched = train.build_optimizer(model, train.lr_schedule())
    step = train.make_train_step(model, LossConfig(max_pos=16), opt, sched)
    quad = np.float32([[10, 10, 40, 12, 38, 30, 9, 28]])
    losses = step(dict(images=np.zeros((2, 64, 64, 3), np.float32),
                       gt_polys=np.stack([quad, quad]),
                       gt_labels=np.int32([[3], [4]]),
                       gt_valid=np.ones((2, 1), bool),
                       img_hw=np.int32([[64, 64], [64, 48]])))
    assert np.isfinite(float(losses["loss_total"]))
    # TTA (two scales x flip) and soft-NMS
    import torch
    from orientedreppoints_tpu_torch.apis import run_inference_tta
    from orientedreppoints_tpu_torch.ops.nms import soft_rnms
    model.eval()
    ds = [dict(img=np.zeros((50, 64, 3), np.float32), scale_factor=1.0,
               img_info=dict(file_name="a.png"))]
    res = run_inference_tta(model, ds, pred.test_cfg,
                            [(0.5, False), (1.0, False), (1.0, True)],
                            canvas=(64, 64))
    assert len(res["a"]) == 15 and sum(len(a) for a in res["a"]) > 0
    quads = torch.tensor([[0., 0, 10, 0, 10, 10, 0, 10],
                          [1., 1, 11, 1, 11, 11, 1, 11]])
    scores, keep = soft_rnms(quads, torch.tensor([0.9, 0.8]))
    assert keep.all() and float(scores[1]) < 0.8
    # the evaluation path: a scene, its tiles and json, the dataset with
    # its test pipeline, and an oracle's scores
    import os, tempfile
    from orientedreppoints_tpu_torch.apis import (build_dataset,
                                                  evaluate_results)
    from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.dota_utils import (
        DOTA10_CLASSES, parse_dota_poly)
    from orientedreppoints_tpu_torch.devkit.evaluation import (
        eval_dota_task1, eval_maoe)
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
    from orientedreppoints_tpu_torch.devkit.result_merge import (
        merge_by_poly, write_task1_results)
    with tempfile.TemporaryDirectory() as wd:
        j = lambda *p: os.path.join(wd, *p)
        names = generate_synth_dota(j("raw"), 1, size=192, n_objects=6,
                                    seed=3)
        ImgSplit(j("raw"), j("split"), gap=32, subsize=128, ext=".npy",
                 num_process=1).splitdata()
        ds = build_dataset(dict(
            type="DotaDataset",
            ann_file=dota2coco_train(j("split"), j("split.json"),
                                     ext=".npy"),
            img_prefix=j("split", "images"), test_mode=True, pipeline=[
                dict(type="LoadImageFromFile"),
                dict(type="RotateResize", img_scale=(64, 64)),
                dict(type="Normalize", mean=[0, 0, 0], std=[1, 1, 1]),
                dict(type="Pad", size_divisor=32)]))
        assert len(ds) == 4 and ds[0]["img"].shape == (64, 64, 3)
        # the training data path: the train pipeline (CorrectBox without
        # cv2, random flips), the loader and a checkpoint
        from orientedreppoints_tpu_torch.apis import build_dataloader
        from orientedreppoints_tpu_torch.utils import checkpoint
        train_ds = build_dataset(dict(
            type="DotaDataset", ann_file=j("split.json"),
            img_prefix=j("split", "images"), pipeline=[
                dict(type="LoadImageFromFile"),
                dict(type="LoadAnnotations", with_bbox=True),
                dict(type="CorrectBox", correct_rbbox=True,
                     refine_rbbox=True),
                dict(type="RotateResize", img_scale=(64, 64)),
                dict(type="RotateRandomFlip", flip_ratio=0.5),
                dict(type="Normalize", mean=[0, 0, 0], std=[1, 1, 1],
                     device=True),
                dict(type="Pad", size_divisor=32)]), device_normalize=True)
        loader = build_dataloader(train_ds, cfg, batch_size=2)
        batch = next(iter(loader))
        assert batch["images"].shape == (2, 64, 64, 3)
        assert batch["images"].dtype == np.uint8 and batch["gt_valid"].any()
        checkpoint.save_checkpoint(j("ckpts"), 1, model, opt, sched, 1)
        assert checkpoint.load_eval_variables(j("ckpts"), model)["epoch"] == 1
        res = {i["file_name"][:-4]: [np.concatenate(
            [a["bboxes"][a["labels"] == c + 1],
             np.ones(((a["labels"] == c + 1).sum(), 1), np.float32)], 1)
            for c in range(15)] for i, a in zip(ds.img_infos, ds.anns)}
        # 1 up to the float64 sums of VOC AP (11 points: 1 + 2.2e-16)
        assert abs(evaluate_results(res, ds)[0] - 1.0) <= 1e-12
        objs = parse_dota_poly(j("raw", "labelTxt", names[0] + ".txt"))
        # float64 rows print as the labels do: the angles match exactly
        oracle = {names[0] + "__1.0__0___0": [np.float64(
            [list(o["poly"]) + [1.0] for o in objs if o["name"] == c]
            ).reshape(-1, 9) for c in DOTA10_CLASSES]}
        write_task1_results(oracle, DOTA10_CLASSES, j("raw_dets"))
        merge_by_poly(j("raw_dets"), j("merged"))
        args = (j("merged", "Task1_{:s}.txt"),
                j("raw", "labelTxt", "{:s}.txt"), names,
                sorted({o["name"] for o in objs}))
        assert abs(eval_dota_task1(*args)[0] - 1.0) <= 1e-12
        assert eval_maoe(*args, ovthresh=0.7)[0] == 0.0
    # Swin: serving through the max-pool FPN, and one AdamW step with
    # DropPath firing
    from orientedreppoints_tpu_torch.apis import build_detector, build_trainer
    from orientedreppoints_tpu_torch.host import load_config
    swin_cfg = load_config("configs/dota/synth_swin_512.py")
    swin_cfg["model"]["backbone"].update(embed_dim=16, depths=[2, 2, 2, 2],
                                         num_heads=[1, 2, 2, 4])
    swin_cfg["model"]["neck"]["out_channels"] = 32
    swin_cfg["model"]["bbox_head"].update(feat_channels=32,
                                          point_feat_channels=32)
    swin_cfg["test_cfg"].update(score_thr=0.0, max_per_img=20,
                                pre_nms_cap=64)
    swin_cfg["tpu"].update(canvas_buckets=[(64, 64)], max_pos=16)
    swin_cfg["data"]["test"]["pipeline"][1]["img_scale"] = (64, 64)
    swin_pred = Predictor(swin_cfg, batch_size=2, compute_dtype="float32",
                          device="cpu")
    out = swin_pred([np.zeros((50, 64, 3), np.uint8)])
    assert sum(len(a) for a in out[0]) > 0
    opt, _, step = build_trainer(swin_pred.model, swin_cfg)
    assert isinstance(opt, torch.optim.AdamW)
    swin_batch = dict(images=np.zeros((2, 64, 64, 3), np.uint8),
                      gt_polys=np.stack([quad, quad]),
                      gt_labels=np.int32([[3], [4]]),
                      gt_valid=np.ones((2, 1), bool),
                      img_hw=np.int32([[64, 64], [64, 48]]))
    # a step's FLOPs, counted without changing the model
    from orientedreppoints_tpu_torch.parallel.train import step_cost_analysis
    before = {k: v.clone() for k, v in swin_pred.model.state_dict().items()}
    assert step_cost_analysis(step, swin_batch) > 0
    assert all(torch.equal(v, swin_pred.model.state_dict()[k])
               for k, v in before.items())
    losses = step(swin_batch)
    assert np.isfinite(float(losses["loss_total"]))
    assert not swin_pred.model.training
    # the single DCNv1 over a pyramid and alone, with its grads
    from orientedreppoints_tpu_torch.ops import deform_conv
    feats = [torch.randn(2, h, h, 8, requires_grad=True) for h in (6, 3)]
    offs = [torch.randn(2, h, h, 18, requires_grad=True) for h in (6, 3)]
    dcn_w = torch.randn(9, 8, 4, requires_grad=True)
    outs = deform_conv.deform_conv2d_pyramid(feats, offs, dcn_w)
    sum(o.square().sum() for o in outs).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in feats + offs + [dcn_w])
    assert deform_conv.deform_conv2d(feats[1], offs[1], dcn_w).shape == (
        2, 3, 3, 4)
    # the hard and ship-only scenes (cv2's drawing rebuilt), the HRSC
    # labels, dataset and evaluators, and the benchmark tool's modes
    import importlib.util
    from orientedreppoints_tpu_torch.core.rbox import rbox2poly
    from orientedreppoints_tpu_torch.data.dota import HrscDataset
    from orientedreppoints_tpu_torch.data.synth import (HARD_RENDER_KWARGS,
                                                        SYNTH_CLASS_SPECS)
    from orientedreppoints_tpu_torch.devkit.evaluation import (
        eval_hrsc2016_map)
    from orientedreppoints_tpu_torch.devkit.hrsc import (eval_hrsc2016,
                                                         generate_txt_labels)
    with tempfile.TemporaryDirectory() as wd:
        j = lambda *p: os.path.join(wd, *p)
        names = generate_synth_dota(j("hard"), 1, size=128, n_objects=6,
                                    seed=4, hard=True)
        assert np.load(j("hard", "images", names[0] + ".npy")).shape == (
            128, 128, 3)
        names = generate_synth_dota(j("ship"), 1, size=128, n_objects=4,
                                    seed=4, specs={"ship": SYNTH_CLASS_SPECS[
                                        "ship"]})
        os.makedirs(j("hrsc", "AllImages"))
        os.makedirs(j("hrsc", "Annotations"))
        open(j("hrsc", "AllImages", "a.bmp"), "w").close()
        with open(j("hrsc", "Annotations", "a.xml"), "w") as f:
            f.write("<HRSC_Image><HRSC_Objects><HRSC_Object><mbox_cx>50"
                    "</mbox_cx><mbox_cy>40</mbox_cy><mbox_w>60</mbox_w>"
                    "<mbox_h>20</mbox_h><mbox_ang>0.3</mbox_ang>"
                    "</HRSC_Object></HRSC_Objects></HRSC_Image>")
        generate_txt_labels(j("hrsc"))
        poly = rbox2poly(np.array([[50, 40, 60, 20, 0.3]]))[0]
        with open(j("Task1_ship.txt"), "w") as f:
            f.write("a 0.9 " + " ".join(str(v) for v in poly) + "\\n")
        args = (j("Task1_{:s}.txt"), j("hrsc", "labelTxt", "{:s}.txt"),
                ["a"])
        assert abs(eval_hrsc2016(*args) - 1.0) <= 1e-12
        assert eval_hrsc2016_map(*args) == eval_hrsc2016(*args)
        ds = build_dataset(dict(
            type="HrscDataset", pipeline=[], test_mode=True,
            ann_file=dota2coco_train(j("ship"), j("ship.json"),
                                     cls_names=("ship",), ext=".npy")))
        assert isinstance(ds, HrscDataset) and len(ds) == 1
    spec = importlib.util.spec_from_file_location(
        "tool", "tools/synth_benchmark_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.class_names(tool.parse_args(["--hrsc"])) == ["ship"]
    assert len(tool.class_names(tool.parse_args(["--hard"]))) == 15
    # the hard-aug train pipeline (mosaic x mixup, HSV, rotation: cv2's
    # warps and colour conversions rebuilt) and one loader batch
    hard_cfg = load_config("configs/dota/synth_r18_512_hard_aug.py")
    with tempfile.TemporaryDirectory() as wd:
        j = lambda *p: os.path.join(wd, *p)
        generate_synth_dota(j("raw"), 1, size=256, n_objects=8, seed=5,
                            hard=True)
        ImgSplit(j("raw"), j("split"), gap=64, subsize=128, ext=".npy",
                 num_process=1).splitdata()
        ds = build_dataset(dict(
            hard_cfg["data"]["train"],
            ann_file=dota2coco_train(j("split"), j("split.json"),
                                     ext=".npy"),
            img_prefix=j("split", "images")))
        batch = next(iter(build_dataloader(ds, hard_cfg, batch_size=2)))
        assert batch["images"].shape == (2, 512, 512, 3)
        assert batch["gt_valid"].any()
    # HRNet, SSD-VGG@512 and ResNeXt: a detector of each, one forward
    tiny = lambda n, block, c: dict(num_modules=1, num_branches=n,
                                    block=block, num_blocks=(1,) * n,
                                    num_channels=c)
    backbones = [
        dict(type="HRNet", extra=dict(
            stage1=tiny(1, "BOTTLENECK", (8,)),
            stage2=tiny(2, "BASIC", (8, 16)),
            stage3=tiny(3, "BASIC", (8, 16, 32)),
            stage4=tiny(4, "BASIC", (8, 16, 32, 64)))),
        dict(type="SSDVGG", input_size=512, depth=11),
        dict(type="ResNeXt", depth=50, groups=4, base_width=4)]
    for bb in backbones:
        det = build_detector(dict(model=dict(
            backbone=bb, neck=dict(out_channels=32, num_outs=5),
            bbox_head=dict(num_classes=16, feat_channels=32,
                           point_feat_channels=32))), "float32")
        det.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs = det.eval()(torch.zeros(1, 64, 64, 3))
        assert [t.shape[1] for t in outs["cls_scores"]] == [8, 4, 2, 1, 1]
        assert all(bool(torch.isfinite(t).all())
                   for t in outs["pts_refine"]), bb["type"]
    # corruption robustness without cv2: the Corrupt stage (all nine
    # corruptions), the JPEG round trip, and the merge's spawn pool, whose
    # children import numpy and the devkit, not torch
    import multiprocessing
    from orientedreppoints_tpu_torch.data import jpeg
    from orientedreppoints_tpu_torch.data.corruptions import CORRUPTIONS
    from orientedreppoints_tpu_torch.data.pipelines import build_pipeline
    img = np.random.RandomState(0).randint(0, 256, (40, 56, 3)).astype(
        np.uint8)
    for name in CORRUPTIONS:
        out = build_pipeline([dict(type="Corrupt", corruption=name,
                                   severity=3)])(dict(
            img=img.copy(), filename="t.png"))["img"]
        assert out.shape == img.shape and out.dtype == np.uint8, name
    assert jpeg.round_trip(img, 58).shape == img.shape
    with tempfile.TemporaryDirectory() as wd:
        j = lambda *p: os.path.join(wd, *p)
        quads = np.float32([[0, 0, 10, 0, 10, 10, 0, 10, 0.9],
                            [1, 1, 11, 1, 11, 11, 1, 11, 0.8]])
        write_task1_results({"s__1.0__0___0": [quads] + [
            np.zeros((0, 9), np.float32)] * 14}, DOTA10_CLASSES, j("raw"))
        merge_by_poly(j("raw"), j("merged"), num_process=2)
        with open(j("merged", "Task1_plane.txt")) as f:
            assert f.read().count("\\n") == 1
    # horizontal NMS, the extra evaluators, soft polygon NMS, DOTA2JSON,
    # the IoU loss, collect_env, profiling, and every tools/*_torch.py
    import importlib.util, glob
    from orientedreppoints_tpu_torch.core.losses import iou_loss
    from orientedreppoints_tpu_torch.devkit.dota2coco import (
        generate_json_labels)
    from orientedreppoints_tpu_torch.devkit.evaluation import (
        eval_dota_task2, eval_ucasaod)
    from orientedreppoints_tpu_torch.devkit.polygon import soft_poly_nms
    from orientedreppoints_tpu_torch.ops.nms import nms_hbb, soft_nms_hbb
    from orientedreppoints_tpu_torch.utils import profiling
    from orientedreppoints_tpu_torch.utils.collect_env import env_info_str
    hbb = torch.tensor([[0., 0, 9, 9], [1, 1, 10, 10], [30, 30, 40, 40]])
    assert nms_hbb(hbb, torch.tensor([0.9, 0.8, 0.7]), 0.5).tolist() == [
        True, False, True]
    assert soft_nms_hbb(hbb, torch.tensor([0.9, 0.8, 0.7]))[1].all()
    assert len(soft_poly_nms(quads, 0.3)[1]) == 2
    assert float(iou_loss(torch.tensor([[0., 0] * 9]),
                          torch.tensor([[0., 0, 4, 0, 4, 4, 0, 4]]),
                          torch.ones(1), 1)) > 0
    assert "PyTorch:" in env_info_str()
    with tempfile.TemporaryDirectory() as wd, profiling.trace(wd):
        with profiling.annotate("r"), profiling.profile_time("t"):
            torch.ones(2).sum()
    with tempfile.TemporaryDirectory() as wd:
        j = lambda *p: os.path.join(wd, *p)
        names = generate_synth_dota(j("raw"), 1, size=128, n_objects=3,
                                    seed=4)
        generate_json_labels(j("raw"), j("labels.json"))
        det = j("Task1_{:s}.txt")
        write_task1_results({names[0]: [quads] * 15}, DOTA10_CLASSES, wd)
        anno = j("raw", "labelTxt", "{:s}.txt")
        assert 0 <= eval_dota_task2(det, anno, names)[0] <= 1
        assert eval_ucasaod(det, anno, names)[0] == 0
    for path in sorted(glob.glob("tools/*_torch.py")):
        spec = importlib.util.spec_from_file_location(
            os.path.basename(path)[:-3], path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    # the visual tools' drawing, the host polygon IoU, DropPath's keys
    from orientedreppoints_tpu_torch.devkit import native
    from orientedreppoints_tpu_torch.utils import jax_random, visualize
    sq = np.array([5.0, 5, 40, 5, 40, 30, 5, 30])
    vis = np.zeros((48, 48, 3), np.uint8)
    visualize.draw_gts(vis, [sq], [3])
    det = np.concatenate([np.full(18, 20.0), sq, [0.9]])
    assert visualize.draw_dets(vis, [det], [2], [True], 0.3) == 1
    assert native.poly_iou_pairs([sq], [sq])[0] == 1.0
    assert jax_random.bernoulli(jax_random.key(0), 0.5, (8,)).shape == (8,)
    probe = ("[__import__('orientedreppoints_tpu_torch.devkit.result_merge'),"
             " sorted(m for m in __import__('sys').modules"
             " if m.split('.')[0] in ('torch', 'jax', 'cv2'))][1]")
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        child = pool.apply(eval, (probe,))
    print("CHILD", child)
    assert child == [], child
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "cv2",
                                           "orientedreppoints_tpu")
                    and sys.modules[m] is not None)
    print("LOADED", loaded)
    assert not loaded, loaded
""")


def test_port_runs_without_jax_flax_cv2():
    # one thread: beside the suite's other workers, torch's default pool
    # oversubscribes the cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


AUG_CONFIGS = ["synth_r18_512_hard_aug", "synth_r50_512_hard_aug",
               "synth_r101_512_hard_aug", "synth_swin_512_hard_aug",
               "synth_r50_1024_hard_aug", "synth_r18_512_hard_aug_mp1024",
               "synth_r18_512_hrsc_aug", "orientedreppoints_swin_tiny_demo",
               "orientedreppoints_r50_mosaic"]


@pytest.mark.parametrize("name", AUG_CONFIGS)
def test_hard_aug_train_pipelines_build(name):
    """Every config whose train pipeline has a hard-aug step builds it;
    those with mosaic or mixup as a MultiSamplePipeline."""
    steps = load_config(os.path.join(REPO, "configs/dota", f"{name}.py"))[
        "data"]["train"]["pipeline"]
    types = {s["type"] for s in steps}
    assert types & {"HSVAugment", "PolyRandomRotate", "PolyMosaic", "MixUp"}
    pipeline = build_pipeline(steps)
    assert isinstance(pipeline, MultiSamplePipeline) == bool(
        types & {"PolyMosaic", "MixUp"})


def test_r50_demo_tree_converts_and_loads_strictly():
    cfg = Config.fromfile(R50)
    model = builder.build_detector(cfg, "float32")
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))
    sd = flax_to_torch(tree)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(sd) == n_leaves
    torch_model = build_detector({k: cfg.get(k) for k in ("model",)},
                                 "float32")
    torch_model.load_state_dict(sd, strict=True)  # no key missing or extra
    assert len(torch_model.state_dict()) == n_leaves


def test_cuda_entries_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(R50, device="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        minarearect.min_area_rect_kernel(torch.zeros(4, 18))
    with pytest.raises(ValueError, match="CUDA tensor"):
        quad_iou.quad_over_mask_kernel(torch.zeros(1, 8, 8), 0.4,
                                       torch.zeros(1, dtype=torch.int32))
    q = torch.zeros(1, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        quad_iou.quad_iou_full_kernel(q, q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        quad_iou.quad_iou_tri_kernel(q, q, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hull_iou.hull_quad_iou_kernel(torch.zeros(1, 4, 9, 2),
                                      torch.ones(1, 4, dtype=torch.int32),
                                      torch.zeros(1, 3, 8))
    t = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        deform_conv.deform_sample_pair_backward_kernel(
            t, t, torch.zeros(6, 18), torch.zeros(6, 36), torch.zeros(6, 36),
            [(1, 2, 3)])


def _hull_call(gt_valid="ok", rows_valid="ok"):
    b, n, g = 2, 5, 3
    masks = {"ok": None, "gt": torch.ones(b, g, dtype=torch.bool),
             "rows": torch.ones(b, n, dtype=torch.bool)}
    return lambda: hull_iou.hull_quad_iou_kernel(
        torch.zeros(b, n, 9, 2), torch.ones(b, n, dtype=torch.int32),
        torch.zeros(b, g, 8),
        masks["gt"] if gt_valid == "ok" else gt_valid,
        masks["rows"] if rows_valid == "ok" else rows_valid)


@pytest.mark.parametrize("call, error, match", [
    (_hull_call(), ValueError, "CUDA tensor"),
    (_hull_call(gt_valid=None, rows_valid=None), ValueError, "CUDA tensor"),
    (_hull_call(gt_valid=torch.ones(2, 3, dtype=torch.uint8)), TypeError,
     "gt_valid: expected torch.bool"),
    (_hull_call(gt_valid=torch.ones(2, 4, dtype=torch.bool)), ValueError,
     r"gt_valid: expected shape \(2, 3\)"),
    (_hull_call(rows_valid=torch.ones(2, 5)), TypeError,
     "rows_valid: expected torch.bool"),
    (_hull_call(rows_valid=torch.ones(5, 2, dtype=torch.bool)), ValueError,
     r"rows_valid: expected shape \(2, 5\)"),
    (lambda: deform_conv.deform_sample_pair_kernel(
        torch.zeros(6, 8), torch.zeros(6, 8), torch.zeros(6, 18),
        [(1, 2, 3)]), ValueError, "CUDA tensor"),
    (lambda: deform_conv.deform_sample_pair_kernel(
        torch.zeros(6, 8), torch.zeros(6, 8), torch.zeros(6, 50),
        [(1, 2, 3)], kernel_size=5), ValueError, "kernel_size 5"),
    (lambda: deform_conv.deform_sample_kernel(
        torch.zeros(6, 8), torch.zeros(6, 18), [(1, 2, 3)]), ValueError,
     "CUDA tensor"),
    (lambda: deform_conv.deform_sample_kernel(
        torch.zeros(6, 8), torch.zeros(6, 50), [(1, 2, 3)], kernel_size=5),
     ValueError, "kernel_size 5"),
    (lambda: deform_conv.deform_sample_backward_kernel(
        torch.zeros(6, 8), torch.zeros(6, 18), torch.zeros(6, 72),
        [(1, 2, 3)]), ValueError, "CUDA tensor"),
    (lambda: deform_conv.deform_sample_kernel(
        torch.zeros(6, 8, dtype=torch.float16), torch.zeros(6, 18),
        [(1, 2, 3)]), TypeError, "no kernel for torch.float16"),
], ids=["hull_cpu", "hull_cpu_no_masks", "gt_valid_dtype", "gt_valid_shape",
        "rows_valid_dtype", "rows_valid_shape", "dcn_fwd_cpu",
        "dcn_fwd_kernel_size", "dcn_single_fwd_cpu",
        "dcn_single_fwd_kernel_size", "dcn_single_bwd_cpu",
        "dcn_single_fwd_dtype"])
def test_kernel_wrappers_refuse_before_any_launch(call, error, match):
    """The wrappers of the redesigned kernels check their inputs (device,
    the masks' dtype and shape, the DCN's kernel size) before a launch;
    the masks are checked first, so that they are refused on the CPU too."""
    ops.reset_launch_counts()
    with pytest.raises(error, match=match):
        call()
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_every_launched_entry_has_a_signature():
    """Every C entry a wrapper launches has its ctypes argument types in
    _ext.SIGNATURES (without them ctypes passes each pointer as a 32-bit
    int), and every exported function a csrc/*.cu file defines is there."""
    from orientedreppoints_tpu_torch.ops import _ext

    launched = set()
    for table in (deform_conv._KERNEL_DTYPES, deform_conv._BWD_KERNEL_DTYPES,
                  deform_conv._SINGLE_KERNEL_DTYPES,
                  deform_conv._SINGLE_BWD_KERNEL_DTYPES):
        launched |= set(table.values())
    assert launched <= set(_ext.SIGNATURES)
    exported = set()
    for src in _ext.CSRC.glob("*.cu"):
        text = src.read_text()
        exported |= set(re.findall(r'extern "C" int (orp_\w+)\(', text))
        exported |= set(re.findall(r"^ORP_\w+\((orp_\w+),", text, re.M))
    assert exported == set(_ext.SIGNATURES)


def test_cpu_tensors_never_launch_a_kernel():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    b, h, w = 2, 6, 5
    outs = {
        "cls_scores": [torch.from_numpy(rng.normal(size=(b, h, w, 15))
                                        .astype(np.float32))],
        "pts_refine": [torch.from_numpy(rng.normal(size=(b, h, w, 18))
                                        .astype(np.float32))],
    }
    dets, labels, valid = decode_detections(outs, strides=(8,), nms_pre=20,
                                            max_per_img=10, pre_nms_cap=64)
    assert valid.any()
    t = torch.from_numpy(rng.normal(size=(b * h * w, 16)).astype(np.float32))
    off = torch.zeros(b * h * w, 18)
    deform_conv.deform_sample_pair(t, t, off, [(b, h, w)])
    g = torch.ones(b * h * w, 9 * 16)
    deform_conv.deform_sample_pair_backward(t, t, off, g, g, [(b, h, w)])
    deform_conv.deform_sample(t, off, [(b, h, w)])
    deform_conv.deform_sample_backward(t, off, g, [(b, h, w)])
    hulls, counts = minarearect.convex_hull_entry(
        torch.from_numpy(rng.normal(size=(4, 18)).astype(np.float32)))
    hull_iou.hull_quad_iou_matrix(hulls[None], counts[None],
                                  torch.zeros(1, 3, 8))
    q = torch.from_numpy(rng.uniform(0, 50, (6, 8)).astype(np.float32))
    quad_iou.quad_iou_matrix(q, q)
    quad_iou.quad_iou_matrix(q, q, upper_tri=True, num_valid=4)
    quad_iou.quad_over_matrix(q, 0.4, 4)
    assert len(ops.KERNELS) == 10
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
