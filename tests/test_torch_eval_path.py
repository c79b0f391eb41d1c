"""The port's evaluation path as a whole against the JAX package's, on the
CPU: rendered scenes -> ImgSplit tiles -> COCO-poly json -> DotaDataset +
test pipeline -> inference -> Task1 txt -> merge_by_poly ->
eval_dota_task1 + eval_maoe, and apis.evaluate_results.

A tiny R-18 (FPN and head widths 32) on 128^2 tiles cut from two 256^2
scenes (the JAX package's PNGs, saved as .npy for the port), with the JAX
model's initial weights, head perturbed (test_torch_slice.perturb_head),
carried through flax_to_torch.  The JAX detections come from model.apply +
decode_detections on the JAX dataset's items (its run_inference shards
over 8 devices, which is slow here), the port's from run_inference on the
port's dataset.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu import apis as apis_ref
from orientedreppoints_tpu.core.rbox import rbbox2result as rbbox2result_ref
from orientedreppoints_tpu.data import synth as synth_ref
from orientedreppoints_tpu.devkit import dota_utils as util_ref
from orientedreppoints_tpu.devkit import evaluation as eval_ref
from orientedreppoints_tpu.devkit import result_merge as merge_ref
from orientedreppoints_tpu.devkit.dota2coco import \
    dota2coco_train as dota2coco_ref
from orientedreppoints_tpu.devkit.img_split import ImgSplit as ImgSplitRef
from orientedreppoints_tpu.models import OrientedRepPointsDetector
from orientedreppoints_tpu.models import decode_detections as decode_ref
from orientedreppoints_tpu.utils import builder
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.apis import build_detector
from orientedreppoints_tpu_torch.data.synth import SYNTH_CLASS_SPECS
from orientedreppoints_tpu_torch.devkit import evaluation, result_merge
from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
from orientedreppoints_tpu_torch.devkit.dota_utils import DOTA10_CLASSES
from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_torch_devkit import assert_same_eval
from test_torch_slice import perturb_head, same_min_rect
from test_torch_tta import fast_jit, jax_ties_first  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDTH = 32
TILE = 128
TC = dict(nms_pre=100, score_thr=0.05, nms=dict(iou_thr=0.4),
          max_per_img=60, pre_nms_cap=256)
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
PIPELINE = [dict(type="LoadImageFromFile"),
            dict(type="RotateResize", img_scale=(TILE, TILE), keep_ratio=True),
            dict(type="Normalize", **NORM),
            dict(type="Pad", size_divisor=32)]
CLASSNAMES = list(SYNTH_CLASS_SPECS)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two 256^2 scenes, split into 9 tiles each at 128 / gap 64, with
    both packages' jsons and datasets."""
    root = tmp_path_factory.mktemp("eval_path")
    names = synth_ref.generate_synth_dota(str(root / "raw"), 2, size=256,
                                          seed=10000, prefix="V")
    os.makedirs(root / "raw_npy" / "images")
    os.makedirs(root / "raw_npy" / "labelTxt")
    for n in names:
        np.save(root / "raw_npy" / "images" / f"{n}.npy",
                cv2.imread(str(root / "raw" / "images" / f"{n}.png")))
        (root / "raw_npy" / "labelTxt" / f"{n}.txt").write_bytes(
            (root / "raw" / "labelTxt" / f"{n}.txt").read_bytes())
    ImgSplitRef(str(root / "raw"), str(root / "ref"), gap=64, subsize=TILE,
                num_process=1).splitdata()
    ImgSplit(str(root / "raw_npy"), str(root / "port"), gap=64,
             subsize=TILE, ext=".npy", num_process=1).splitdata()
    dota2coco_ref(str(root / "ref"), str(root / "ref.json"))
    dota2coco_train(str(root / "port"), str(root / "port.json"), ext=".npy")

    def dcfg(side):
        return dict(type="DotaDataset", ann_file=str(root / f"{side}.json"),
                    img_prefix=str(root / side / "images"),
                    pipeline=PIPELINE, test_mode=True)
    return dict(root=root, names=names,
                ds=apis.build_dataset(dcfg("port")),
                ds_ref=builder.build_dataset(dcfg("ref")))


@pytest.fixture(scope="module")
def models():
    model_ref = OrientedRepPointsDetector(
        depth=18, num_classes=16, fpn_out_channels=WIDTH,
        head_kwargs=dict(feat_channels=WIDTH, point_feat_channels=WIDTH))
    variables = fast_jit(model_ref.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = perturb_head(jax.tree_util.tree_map(np.array,
                                                    dict(variables)),
                             np.random.default_rng(0))
    model = build_detector({"model": dict(
        backbone=dict(type="ResNet", depth=18),
        neck=dict(out_channels=WIDTH, num_outs=5),
        bbox_head=dict(num_classes=16, feat_channels=WIDTH,
                       point_feat_channels=WIDTH))}, "float32")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model_ref, variables, model.eval()


def reference_inference(model_ref, variables, ds_ref, batch=2):
    """The JAX run_inference's batching, with model.apply +
    decode_detections in place of its sharded call."""
    apply = fast_jit(model_ref.apply)
    decode = fast_jit(lambda o, sf: decode_ref(
        o, nms_pre=TC["nms_pre"], score_thr=TC["score_thr"],
        iou_thr=TC["nms"]["iou_thr"], max_per_img=TC["max_per_img"],
        pre_nms_cap=TC["pre_nms_cap"], scale_factor=sf))
    results = {}
    for lo in range(0, len(ds_ref), batch):
        items = [ds_ref[i] for i in range(lo, min(lo + batch, len(ds_ref)))]
        x = np.zeros((batch, TILE, TILE, 3), np.float32)
        sfs = np.ones((batch, 1, 1), np.float32)
        for bi, s in enumerate(items):
            x[bi, :s["img"].shape[0], :s["img"].shape[1]] = s["img"]
            sfs[bi] = s["scale_factor"]
        dets, labels, valid = map(np.asarray, decode(
            apply(variables, jnp.asarray(x)), jnp.asarray(sfs)))
        for bi, s in enumerate(items):
            name = s["img_info"]["file_name"][:-4]
            results[name] = rbbox2result_ref(dets[bi][valid[bi]][:, -9:],
                                             labels[bi][valid[bi]], 16)
    return results


@pytest.fixture(scope="module")
def results(data, models):
    model_ref, variables, model = models
    got = apis.run_inference(model, data["ds"], TC, canvas=(TILE, TILE),
                             batch_size=2)
    return got, (model_ref, variables)


def test_run_inference_matches_jax(data, results,
                                   jax_ties_first):  # noqa: F811
    """Each framework runs its own model: scores within 1e-4, polygons
    within 0.05 px up to corner order (test_torch_tta's tolerances); dets
    whose scores differ by rounding may swap places, so they are matched
    one to one."""
    got, (model_ref, variables) = results
    ref = reference_inference(model_ref, variables, data["ds_ref"])
    assert set(got) == set(ref) and len(got) == 18
    total = 0
    for name, per_class in ref.items():
        assert len(got[name]) == len(per_class) == 15
        for ci, (a, b) in enumerate(zip(got[name], per_class)):
            assert a.shape == b.shape and a.dtype == np.float32, (name, ci)
            free = np.ones(len(b), bool)
            for row in a:
                hit = free & (np.abs(b[:, 8] - row[8]) <= 1e-4) & \
                    same_min_rect(np.tile(row[:8], (len(b), 1)), b[:, :8],
                                  tol=0.05)
                assert hit.any(), (name, ci, row)
                free[np.argmax(hit)] = False
            total += len(a)
    assert total > 200


def with_oracle(res, ds, rng):
    """The detections plus each tile's gts, jittered, as detections of
    their class: the evaluators then match, dedup and score real pairs."""
    out = {}
    for info, ann in zip(ds.img_infos, ds.anns):
        name = info["file_name"][:-4]
        per_class = []
        for ci in range(15):
            gts = ann["bboxes"][ann["labels"] == ci + 1].astype(np.float64)
            rows = np.concatenate([gts + rng.normal(0, 1.5, gts.shape),
                                   rng.random((len(gts), 1))], 1)
            per_class.append(np.concatenate(
                [res[name][ci], rows.astype(np.float32)]))
        out[name] = per_class
    return out


@pytest.mark.parametrize("dets", ["model", "model_and_oracle"])
def test_both_chains_score_alike(data, results, tmp_path, dets):
    """The port's detections through each package's write -> merge ->
    score: the same Task1 and merged files, byte for byte, and the same
    mAP and mAOE."""
    res = results[0]
    if dets == "model_and_oracle":
        res = with_oracle(res, data["ds"], np.random.default_rng(1))
    annopath = str(data["root"] / "raw" / "labelTxt" / "{:s}.txt")
    scores = {}
    for side, write, merge, ev in (
            ("port", result_merge.write_task1_results,
             result_merge.merge_by_poly, evaluation),
            ("ref", merge_ref.write_task1_results,
             lambda a, b: merge_ref.merge_by_poly(a, b, num_process=1),
             eval_ref)):
        raw, merged = tmp_path / f"{side}_raw", tmp_path / f"{side}_merged"
        write(res, DOTA10_CLASSES, str(raw))
        merge(str(raw), str(merged))
        detpath = str(merged / "Task1_{:s}.txt")
        scores[side] = (
            ev.eval_dota_task1(detpath, annopath, data["names"], CLASSNAMES,
                               use_07_metric=False),
            ev.eval_maoe(detpath, annopath, data["names"], CLASSNAMES,
                         ovthresh=0.7, return_mod90=True))
    for c in DOTA10_CLASSES:
        for d in ("raw", "merged"):
            assert (tmp_path / f"port_{d}" / f"Task1_{c}.txt").read_bytes() \
                == (tmp_path / f"ref_{d}" / f"Task1_{c}.txt").read_bytes()
    assert scores["port"] == scores["ref"]
    (mAP, _), (mAOE, aoes, _, _) = scores["port"]
    if dets == "model_and_oracle":
        assert mAP > 0.5 and len(aoes) > 0


@pytest.mark.parametrize("dets", ["model", "model_and_oracle"])
def test_evaluate_results_agree(data, results, dets):
    res = results[0]
    if dets == "model_and_oracle":
        res = with_oracle(res, data["ds"], np.random.default_rng(2))
    got = apis.evaluate_results(res, data["ds"])
    assert_same_eval(got, apis_ref.evaluate_results(res, data["ds_ref"]))
    if dets == "model_and_oracle":
        assert got[0] > 0.5


def test_oracle_scores_exactly_one(data, tmp_path):
    """The scene labels written as Task1 detections of score 1 score mAP
    1 and mAOE 0 through the port's merge and evaluators."""
    raw = tmp_path / "raw"
    os.makedirs(raw)
    for c in DOTA10_CLASSES:
        with open(raw / f"Task1_{c}.txt", "w") as f:
            for n in data["names"]:
                for o in util_ref.parse_dota_poly(str(
                        data["root"] / "raw" / "labelTxt" / f"{n}.txt")):
                    if o["name"] == c:
                        f.write(f"{n}__1.0__0___0 1.0 "
                                + " ".join(str(v) for v in o["poly"]) + "\n")
    result_merge.merge_by_poly(str(raw), str(tmp_path / "merged"))
    detpath = str(tmp_path / "merged" / "Task1_{:s}.txt")
    annopath = str(data["root"] / "raw" / "labelTxt" / "{:s}.txt")
    mAP, aps = evaluation.eval_dota_task1(detpath, annopath, data["names"],
                                          CLASSNAMES, use_07_metric=False)
    mAOE, _, mod90, _ = evaluation.eval_maoe(
        detpath, annopath, data["names"], CLASSNAMES, ovthresh=0.7,
        return_mod90=True)
    # the area under a perfect curve sums to 1 within float64 rounding
    # (exactly 1 for most gt counts; 24 gts give 1 - 1.1e-16)
    assert abs(mAP - 1.0) <= 1e-12, aps
    assert (mAOE, mod90) == (0.0, 0.0)
