"""The port's Task2 (horizontal) and UCAS-AOD evaluators, soft polygon NMS
and DOTA2JSON labels (devkit/evaluation.py, devkit/polygon.py,
devkit/dota2coco.py) against the JAX package's, on the CPU.

The port's rendered hard scenes (15 classes), their labels and seeded
detections made from them (jittered gts, duplicates, false positives) go
through both packages.  Both sides are float64 numpy with the same
arithmetic in the same order: every AP, mAP and decayed score is compared
exactly, and the json files byte for byte.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from orientedreppoints_tpu.devkit import dota2coco as d2c_ref
from orientedreppoints_tpu.devkit import evaluation as eval_ref
from orientedreppoints_tpu.devkit import polygon as pg_ref
from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
from orientedreppoints_tpu_torch.devkit import dota2coco, evaluation
from orientedreppoints_tpu_torch.devkit import dota_utils as util
from orientedreppoints_tpu_torch.devkit import polygon as pg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


UCAS_NAMES = {"plane": "airplane", "small-vehicle": "car"}


def write_dets(path_fmt: str, dets: dict) -> None:
    """{class: [(image, score, poly8)]} -> one Task1 file per class."""
    for cls, rows in dets.items():
        with open(path_fmt.format(cls), "w") as f:
            for name, score, poly in rows:
                f.write(f"{name} {score:.6f} "
                        + " ".join(f"{v:.1f}" for v in poly) + "\n")


def seeded_dets(labels: dict, rng) -> dict:
    """Per class: each gt jittered (some far), a duplicate of every third,
    and a false positive a gt; scores from the rng."""
    dets = {}
    for name, objs in labels.items():
        for o in objs:
            poly = np.asarray(o["poly"], np.float64).reshape(-1)
            rows = dets.setdefault(o["name"], [])
            jitter = rng.normal(0, 1.5 if rng.random() < 0.8 else 9.0, 8)
            rows.append((name, rng.random(), poly + jitter))
            if rng.random() < 1 / 3:
                rows.append((name, rng.random(), poly + rng.normal(0, 3, 8)))
            rows.append((name, rng.random(),
                         poly + rng.uniform(-80, 80, 2).repeat(4)[
                             [0, 4, 1, 5, 2, 6, 3, 7]]))
    return dets


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_extra")
    raw = str(root / "raw")
    names = generate_synth_dota(raw, 3, size=320, n_objects=14, seed=11,
                                hard=True)
    labels = {n: util.parse_dota_poly(osp.join(raw, "labelTxt", n + ".txt"))
              for n in names}
    # one more label file: difficult 1 and 2, and a class not in DOTA-1.0
    extra = [dict(poly=[[10, 10], [60, 10], [60, 40], [10, 40]],
                  name="plane", difficult="1"),
             dict(poly=[[70, 70], [90, 72], [88, 95], [68, 92]],
                  name="ship", difficult="2"),
             dict(poly=[[5, 100], [50, 100], [50, 130], [5, 130]],
                  name="container-crane", difficult="0")]
    util.write_dota_poly(osp.join(raw, "labelTxt", "X0000.txt"), extra)
    labels["X0000"] = util.parse_dota_poly(
        osp.join(raw, "labelTxt", "X0000.txt"))
    dets = seeded_dets(labels, np.random.default_rng(12))
    det_fmt = str(root / "Task1_{:s}.txt")
    write_dets(det_fmt, dets)
    # UCAS-AOD: the same scenes with two classes renamed
    ucas = root / "ucas"
    os.makedirs(ucas / "labelTxt")
    for n, objs in labels.items():
        util.write_dota_poly(str(ucas / "labelTxt" / f"{n}.txt"), [
            dict(o, name=UCAS_NAMES.get(o["name"], o["name"]))
            for o in objs])
    write_dets(str(ucas / "Task1_{:s}.txt"),
               {UCAS_NAMES[c]: r for c, r in dets.items()
                if c in UCAS_NAMES})
    return dict(root=root, raw=raw, names=sorted(labels), det_fmt=det_fmt,
                anno_fmt=osp.join(raw, "labelTxt", "{:s}.txt"),
                ucas_det=str(ucas / "Task1_{:s}.txt"),
                ucas_anno=str(ucas / "labelTxt" / "{:s}.txt"), dets=dets)


@pytest.mark.parametrize("use_07", [True, False])
def test_task2_matches_jax(scenes, use_07):
    args = (scenes["det_fmt"], scenes["anno_fmt"], scenes["names"])
    got = evaluation.eval_dota_task2(*args, use_07_metric=use_07)
    ref = eval_ref.eval_dota_task2(*args, use_07_metric=use_07)
    assert got == ref
    # the horizontal overlap is not the oriented one: Task1 scores differ
    task1 = evaluation.eval_dota_task1(*args, use_07_metric=use_07)
    assert 0.1 < got[0] < 1.0 and got[0] != task1[0]


@pytest.mark.parametrize("hbb", [False, True])
def test_voc_eval_poly_hbb_matches_jax(scenes, hbb):
    for cls in ("plane", "ship", "small-vehicle"):
        args = (scenes["det_fmt"], scenes["anno_fmt"], scenes["names"], cls,
                0.5, True)
        got = evaluation.voc_eval_poly(*args, hbb=hbb)
        ref = eval_ref.voc_eval_poly(*args, hbb=hbb)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]


@pytest.mark.parametrize("ovthresh", [0.7, 0.5])
def test_ucasaod_matches_jax(scenes, ovthresh):
    args = (scenes["ucas_det"], scenes["ucas_anno"], scenes["names"])
    got = evaluation.eval_ucasaod(*args, ovthresh=ovthresh)
    ref = eval_ref.eval_ucasaod(*args, ovthresh=ovthresh)
    assert evaluation.UCAS_AOD_CLASSES == eval_ref.UCAS_AOD_CLASSES
    assert got == ref and set(got[1]) == {"car", "airplane"}
    assert got[0] > 0


@pytest.mark.parametrize("method", ["linear", "gaussian", "original"])
def test_soft_poly_nms_matches_jax(scenes, method):
    rows = [r for c in ("small-vehicle", "plane", "ship")
            for r in scenes["dets"].get(c, [])]
    dets = np.array([np.append(p, s) for _, s, p in rows])
    got = pg.soft_poly_nms(dets, 0.3, method=method, min_score=0.05)
    ref = pg_ref.soft_poly_nms(dets, 0.3, method=method, min_score=0.05)
    assert 0 < len(ref[1]) < len(dets)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("trainval", [True, False])
def test_generate_json_labels_byte_for_byte(scenes, trainval, tmp_path):
    got = dota2coco.generate_json_labels(scenes["raw"],
                                         str(tmp_path / "port.json"),
                                         trainval)
    ref = d2c_ref.generate_json_labels(scenes["raw"],
                                       str(tmp_path / "ref.json"), trainval)
    with open(got, "rb") as a, open(ref, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert (b'"bboxes_ignore": [[' in data) == trainval
