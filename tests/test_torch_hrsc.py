"""The port's HRSC2016 path against the JAX package's, on the CPU:
rbox2poly, the XML parser and labelTxt writer, the VOC AP of the one
class ship (eval_hrsc2016, eval_hrsc2016_map) on seeded det and gt files,
and HrscDataset (through apis.build_dataset) on one json.  Each is equal
exactly: arrays element for element, files byte for byte, APs as
floats."""

import re
import shutil

import numpy as np
import pytest
import torch

from orientedreppoints_tpu.core import rbox as rbox_ref
from orientedreppoints_tpu.data.dota import HrscDataset as HrscRef
from orientedreppoints_tpu.devkit import evaluation as evaluation_ref
from orientedreppoints_tpu.devkit import hrsc as hrsc_ref
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.core.rbox import rbox2poly
from orientedreppoints_tpu_torch.data.dota import HrscDataset
from orientedreppoints_tpu_torch.devkit import evaluation, hrsc
from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
from orientedreppoints_tpu_torch.devkit.dota_utils import write_dota_poly


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rbox2poly_equal():
    """Seeded boxes at every angle, squares and slivers among them."""
    rng = np.random.default_rng(0)
    boxes = np.concatenate([
        rng.uniform(0, 800, (300, 2)), rng.uniform(1, 300, (300, 2)),
        rng.uniform(-2 * np.pi, 2 * np.pi, (300, 1))], 1)
    boxes[::7, 3] = boxes[::7, 2]  # squares: the begin-point ties
    boxes[::11, 4] = np.round(boxes[::11, 4] / (np.pi / 2)) * (np.pi / 2)
    got = rbox2poly(boxes)
    assert got.dtype == np.float32 and got.shape == (300, 8)
    np.testing.assert_array_equal(got, rbox_ref.rbox2poly(boxes))
    np.testing.assert_array_equal(rbox2poly(boxes[0]),
                                  rbox_ref.rbox2poly(boxes[0]))


XML = """<?xml version="1.0" encoding="utf-8"?>
<HRSC_Image>
  <Img_ID>{name}</Img_ID>
  <HRSC_Objects>
{objects}
  </HRSC_Objects>
</HRSC_Image>
"""
OBJECT = """    <HRSC_Object>
      <Class_ID>100000001</Class_ID>
      <difficult>{difficult}</difficult>
      <mbox_cx>{cx}</mbox_cx>
      <mbox_cy>{cy}</mbox_cy>
      <mbox_w>{w}</mbox_w>
      <mbox_h>{h}</mbox_h>
      <mbox_ang>{ang}</mbox_ang>
    </HRSC_Object>"""


@pytest.fixture(scope="module")
def hrsc_root(tmp_path_factory):
    """AllImages with four images, Annotations with XMLs for three: seeded
    boxes, difficult 0 and 1, one field missing and one empty, and one
    XML without objects."""
    root = tmp_path_factory.mktemp("hrsc")
    (root / "AllImages").mkdir()
    (root / "Annotations").mkdir()
    rng = np.random.default_rng(1)
    for i, n_obj in enumerate((5, 3, 0, None)):
        name = f"1000{i:05d}"
        (root / "AllImages" / f"{name}.bmp").write_bytes(b"")
        if n_obj is None:
            continue
        objs = []
        for k in range(n_obj):
            cx, cy = rng.uniform(50, 900, 2)
            w, h = rng.uniform(20, 400), rng.uniform(8, 80)
            objs.append(OBJECT.format(
                difficult=int(k % 3 == 1), cx=f"{cx:.4f}", cy=f"{cy:.4f}",
                w=f"{w:.4f}", h=f"{h:.4f}",
                ang=f"{rng.uniform(-np.pi / 2, np.pi / 2):.6f}"))
        if n_obj == 3:  # no difficult field, an empty angle
            objs[2] = re.sub(r"<mbox_ang>[^<]*</mbox_ang>",
                             "<mbox_ang></mbox_ang>", objs[2].replace(
                                 "<difficult>0</difficult>", ""))
        (root / "Annotations" / f"{name}.xml").write_text(
            XML.format(name=name, objects="\n".join(objs)))
    return root


def test_parse_hrsc_xml_equal(hrsc_root):
    for xml in sorted((hrsc_root / "Annotations").iterdir()):
        got = hrsc._parse_hrsc_xml(str(xml))
        assert got == hrsc_ref._parse_hrsc_xml(str(xml))
    rows = hrsc._parse_hrsc_xml(str(hrsc_root / "Annotations"
                                    / "100000001.xml"))
    assert len(rows) == 3 and rows[2][4] == 0.0 and rows[2][5] == "0"


def test_generate_txt_labels_equal(hrsc_root, tmp_path):
    """The port's labelTxt against the JAX package's, written from copies
    of the same folder."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    shutil.copytree(hrsc_root, port)
    shutil.copytree(hrsc_root, ref)
    out = hrsc.generate_txt_labels(str(port))
    hrsc_ref.generate_txt_labels(str(ref))
    files = sorted(p.name for p in (ref / "labelTxt").iterdir())
    assert sorted(p.name for p in (port / "labelTxt").iterdir()) == files
    assert len(files) == 4 and out == str(port / "labelTxt")
    for f in files:
        assert (port / "labelTxt" / f).read_bytes() == \
            (ref / "labelTxt" / f).read_bytes()
    assert (port / "labelTxt" / files[0]).read_text().count(" ship 1\n") == 2


@pytest.fixture(scope="module")
def det_gt(tmp_path_factory):
    """Seeded ship gts (some difficult) in labelTxt files of 6 images, and
    a Task1_ship.txt of detections: jittered gts, duplicates and misses
    with random scores."""
    root = tmp_path_factory.mktemp("detgt")
    (root / "labelTxt").mkdir()
    rng = np.random.default_rng(2)
    names, lines = [f"P{i:04d}" for i in range(6)], []
    for n in names:
        boxes = np.concatenate([rng.uniform(60, 500, (8, 2)),
                                rng.uniform(30, 120, (8, 1)),
                                rng.uniform(10, 30, (8, 1)),
                                rng.uniform(0, np.pi, (8, 1))], 1)
        polys = rbox2poly(boxes).astype(np.float64)
        write_dota_poly(str(root / "labelTxt" / f"{n}.txt"), [
            dict(poly=p, name="ship", difficult="1" if k == 3 else "0")
            for k, p in enumerate(polys)])
        for k, p in enumerate(polys):
            if k == 5:
                continue  # a miss
            for _ in range(1 + (k == 2)):  # a duplicate
                q = p + rng.normal(0, 4 if k % 2 else 1, 8)
                lines.append(" ".join([n, f"{rng.uniform(0.05, 1):.4f}"]
                                      + [f"{v:.2f}" for v in q]))
        q = rng.uniform(0, 600, 8)  # a false positive
        lines.append(" ".join([n, f"{rng.uniform(0.05, 1):.4f}"]
                              + [f"{v:.2f}" for v in q]))
    (root / "Task1_ship.txt").write_text("\n".join(lines) + "\n")
    return (str(root / "Task1_{:s}.txt"),
            str(root / "labelTxt" / "{:s}.txt"), names)


@pytest.mark.parametrize("ovthresh, use_07", [(0.5, True), (0.5, False),
                                               (0.7, True), (0.7, False)])
def test_eval_hrsc2016_equal(det_gt, ovthresh, use_07):
    det, anno, names = det_gt
    want = hrsc_ref.eval_hrsc2016(det, anno, names, ovthresh, use_07)
    assert 0.2 < want < 1.0
    assert hrsc.eval_hrsc2016(det, anno, names, ovthresh, use_07) == want
    assert evaluation.eval_hrsc2016_map(det, anno, names, ovthresh,
                                        use_07) == want
    assert evaluation_ref.eval_hrsc2016_map(det, anno, names, ovthresh,
                                            use_07) == want


def test_hrsc_dataset_equal(tmp_path):
    """One json of ship tiles (dota2coco_train with the class ship) read
    by both packages' HrscDataset, train and test mode."""
    (tmp_path / "images").mkdir()
    (tmp_path / "labelTxt").mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        np.save(tmp_path / "images" / f"T{i}.npy",
                np.zeros((64 + 8 * i, 80, 3), np.uint8))
        boxes = np.concatenate([rng.uniform(10, 60, (i, 2)),
                                rng.uniform(10, 30, (i, 2)),
                                rng.uniform(0, np.pi, (i, 1))], 1)
        write_dota_poly(str(tmp_path / "labelTxt" / f"T{i}.txt"), [
            dict(poly=p, name="ship", difficult=str(k % 2))
            for k, p in enumerate(rbox2poly(boxes).astype(np.float64))])
    ann = dota2coco_train(str(tmp_path), str(tmp_path / "ship.json"),
                          cls_names=("ship",), ext=".npy")
    for test_mode in (False, True):
        got = apis.build_dataset(dict(type="HrscDataset", ann_file=ann,
                                      pipeline=[], test_mode=test_mode))
        ref = HrscRef(ann, test_mode=test_mode)
        assert isinstance(got, HrscDataset)
        assert got.CLASSES == ref.CLASSES == ("ship",)
        assert len(got) == len(ref) == (4 if test_mode else 3)
        assert got.img_infos == ref.img_infos
        np.testing.assert_array_equal(got.flag, ref.flag)
        for a, b in zip(got.anns, ref.anns):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(NotImplementedError, match="UcasDataset"):
        apis.build_dataset(dict(type="UcasDataset", ann_file=ann,
                                pipeline=[]))
