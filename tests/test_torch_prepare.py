"""The port's DOTA and HRSC preparation against the JAX package's, on the
CPU, on the same cv2-written scenes.

The JAX generator writes PNG scenes with cv2 (train, val and test, the
test split without labels; the val scene cut to a non-square 256 x 200).
On them ImgSplit at rates 0.5, 1.0 and 1.5, SplitOnlyImage,
prepare_dota1_train_val, prepare_dota1_ms, dota2coco_train and
dota2coco_test of both packages give the same file names, byte-equal
labelTxt files and equal json; tiles are pixel-equal with cv2's IPP off
(JAX splits in this process, num_process 1, so the switch holds) and
within one grey level on at most IPP_SHARE of the values with it on.
prepare_hrsc2016 on .bmp scenes as tests/test_hrsc.py writes them, and
the HrscDataset reading them.  The port's spawn pool (num_process 2)
writes the files of one process.
"""

import contextlib
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.data import synth as synth_ref
from orientedreppoints_tpu.devkit import dota2coco as coco_ref
from orientedreppoints_tpu.devkit import hrsc as hrsc_ref
from orientedreppoints_tpu.devkit import img_split as split_ref
from orientedreppoints_tpu.devkit import prepare as prepare_ref
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.devkit import dota2coco, hrsc, img_split
from orientedreppoints_tpu_torch.devkit import prepare
from test_hrsc import OBJ_TMPL, XML_TMPL
from test_torch_image_io import IPP_SHARE

SUB, GAP = 128, 48


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def ipp(on: bool):
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(before)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """data_root/{train,val,test}: one JAX-rendered scene each."""
    root = tmp_path_factory.mktemp("raw")
    for i, split in enumerate(("train", "val", "test")):
        synth_ref.generate_synth_dota(str(root / split), 1, size=256,
                                      n_objects=12, seed=20 + i,
                                      prefix=split[:2].upper())
    val = root / "val" / "images" / "VA0000.png"
    cv2.imwrite(str(val), cv2.imread(str(val))[:200])
    shutil.rmtree(root / "test" / "labelTxt")
    return root


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_tree(port, ref, share=0.0):
    """Same files; .txt byte-equal, .json equal, images equal as cv2 reads
    them, or within one grey level on at most `share` of the values."""
    names = files(ref)
    assert files(port) == names and names
    for name in names:
        a, b = os.path.join(port, name), os.path.join(ref, name)
        if name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), name
        elif name.endswith((".png", ".bmp")):
            got, want = cv2.imread(a), cv2.imread(b)
            assert got.shape == want.shape, name
            diff = np.abs(got.astype(int) - want)
            assert diff.max() <= (1 if share else 0), name
            assert (diff > 0).mean() <= share, name
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    return names


@pytest.mark.parametrize("rate", [0.5, 1.0, 1.5])
def test_img_split_rates_match_jax(raw, tmp_path, rate):
    """Tiles and labels of the train scene at each rate; at rates other
    than 1 also against JAX with IPP on."""
    for side, cls in (("port", img_split.ImgSplit),
                      ("ref", split_ref.ImgSplit)):
        with ipp(False):
            cls(str(raw / "train"), str(tmp_path / side), gap=GAP,
                subsize=SUB, num_process=1).splitdata(rate)
    names = assert_same_tree(tmp_path / "port", tmp_path / "ref")
    assert all(f"__{rate}__" in n for n in names)
    assert len(names) == 2 * {0.5: 1, 1.0: 9, 1.5: 25}[rate]
    if rate != 1.0:
        with ipp(True):
            split_ref.ImgSplit(str(raw / "train"), str(tmp_path / "ipp"),
                               gap=GAP, subsize=SUB,
                               num_process=1).splitdata(rate)
        assert_same_tree(tmp_path / "port", tmp_path / "ipp", IPP_SHARE)


def test_split_options_match_jax(raw, tmp_path):
    """SplitOnlyImage of the test scene at 1.5; the val scene at 0.5
    (128 x 100) without padding or the best point order, and a missing
    scene skipped."""
    for side, mod in (("port", img_split), ("ref", split_ref)):
        with ipp(False):
            mod.SplitOnlyImage(str(raw / "test"), str(tmp_path / side / "t"),
                               gap=GAP, subsize=SUB,
                               num_process=1).splitdata(1.5)
            s = mod.ImgSplit(str(raw / "val"), str(tmp_path / side / "v"),
                             gap=GAP, subsize=SUB, padding=False,
                             choosebestpoint=False, num_process=1)
            s.splitdata(0.5)
            s.split_single("missing", 1.0)
    names = assert_same_tree(tmp_path / "port", tmp_path / "ref")
    assert not any(n.startswith("t/labelTxt") for n in names)
    assert len(names) == 25 + 2
    assert cv2.imread(str(tmp_path / "port" / "v" / "images"
                          / "VA0000__0.5__0___0.png")).shape == (100, 128, 3)


@pytest.mark.parametrize("kind", ["train_val", "ms"])
def test_prepare_matches_jax(raw, tmp_path, kind):
    """prepare_dota1_train_val (gap 64) and prepare_dota1_ms (rate 1 at gap
    64, 0.5 and 1.5 at 48) at subsize 128: the whole trees, jsons too."""
    port = dict(train_val=prepare.prepare_dota1_train_val,
                ms=prepare.prepare_dota1_ms)[kind]
    ref = dict(train_val=prepare_ref.prepare_dota1_train_val,
               ms=prepare_ref.prepare_dota1_ms)[kind]
    kw = dict(gap=64) if kind == "train_val" else dict(gap_ss=64, gap_ms=48)
    outs = {}
    for side, fn in (("port", port), ("ref", ref)):
        with ipp(False):
            outs[side] = fn(str(raw), str(tmp_path / side), subsize=SUB,
                            num_process=1, **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in outs["port"]] \
        == [os.path.relpath(p, tmp_path / "ref") for p in outs["ref"]]
    names = assert_same_tree(tmp_path / "port", tmp_path / "ref")
    test_json = [n for n in names if n.endswith("test_dota.json")]
    with open(tmp_path / "port" / test_json[0]) as f:
        data = json.load(f)
    assert data["annotations"] == [] and len(data["images"]) > 1
    if kind == "ms":
        rates = {n.split("__")[1] for n in names if n.endswith(".png")}
        assert rates == {"0.5", "1.0", "1.5"}


def test_split_pool_writes_the_files_of_one_process(raw, tmp_path):
    """ImgSplit of two scenes at rate 1.5 in a spawn pool of 2 workers:
    every file byte for byte as with one process."""
    for split in ("train", "val"):
        for sub in ("images", "labelTxt"):
            shutil.copytree(raw / split / sub, tmp_path / "raw" / sub,
                            dirs_exist_ok=True)
    for n in (1, 2):
        img_split.ImgSplit(str(tmp_path / "raw"), str(tmp_path / str(n)),
                           gap=GAP, subsize=SUB,
                           num_process=n).splitdata(1.5)
    names = files(tmp_path / "1")
    assert names == files(tmp_path / "2") and len(names) == 2 * (25 + 20)
    for name in names:
        assert (tmp_path / "1" / name).read_bytes() == (
            tmp_path / "2" / name).read_bytes(), name


def test_dota2coco_skips_what_cv2_cannot_read(raw, tmp_path):
    """An image whose file is not an image, and a label without its image,
    are skipped by both packages' jsons."""
    for sub in ("images", "labelTxt"):
        shutil.copytree(raw / "train" / sub, tmp_path / sub)
    (tmp_path / "images" / "bad.png").write_bytes(b"not a png")
    shutil.copy(tmp_path / "labelTxt" / "TR0000.txt",
                tmp_path / "labelTxt" / "bad.txt")
    shutil.copy(tmp_path / "labelTxt" / "TR0000.txt",
                tmp_path / "labelTxt" / "gone.txt")
    for fn, ref in ((dota2coco.dota2coco_train, coco_ref.dota2coco_train),
                    (dota2coco.dota2coco_test, coco_ref.dota2coco_test)):
        fn(str(tmp_path), str(tmp_path / "port.json"))
        ref(str(tmp_path), str(tmp_path / "ref.json"))
        got = json.loads((tmp_path / "port.json").read_text())
        assert got == json.loads((tmp_path / "ref.json").read_text())
        assert [i["file_name"] for i in got["images"]] == ["TR0000.png"]


@pytest.fixture
def hrsc_tree(tmp_path):
    """A Train and a Test split of two .bmp images each, written by cv2
    with their XML, as tests/test_hrsc.py writes them, copied twice."""
    rng = np.random.default_rng(3)
    root = tmp_path / "ref" / "HRSC2016"
    for split in ("Train", "Test"):
        (root / split / "AllImages").mkdir(parents=True)
        (root / split / "Annotations").mkdir()
        for k in range(2):
            name = f"1000{split[:2]}{k}"
            img = rng.integers(0, 256, (150 + 10 * k, 170, 3)).astype(
                np.uint8)
            cv2.imwrite(str(root / split / "AllImages" / f"{name}.bmp"), img)
            objs = [(rng.uniform(40, 120), rng.uniform(40, 100),
                     rng.uniform(30, 60), rng.uniform(10, 20),
                     rng.uniform(-1.5, 1.5), j % 2) for j in range(k + 1)]
            body = "\n".join(OBJ_TMPL.format(cx=o[0], cy=o[1], w=o[2],
                                              h=o[3], ang=o[4],
                                              difficult=o[5]) for o in objs)
            (root / split / "Annotations" / f"{name}.xml").write_text(
                XML_TMPL.format(img_id=name, objects=body))
    shutil.copytree(tmp_path / "ref", tmp_path / "port", symlinks=True)
    return tmp_path


def test_prepare_hrsc2016_matches_jax(hrsc_tree):
    """The labelTxt, the images symlink and the json of each split; the
    HrscDataset reads the .bmp images as cv2 does."""
    hrsc_ref.prepare_hrsc2016(str(hrsc_tree / "ref" / "HRSC2016"))
    hrsc.prepare_hrsc2016(str(hrsc_tree / "port" / "HRSC2016"))
    names = assert_same_tree(hrsc_tree / "port", hrsc_tree / "ref")
    assert "HRSC2016/Test/hrsc_test.json" in names
    for split in ("Train", "Test"):
        d = hrsc_tree / "port" / "HRSC2016" / split
        assert os.path.islink(d / "images")
        assert os.readlink(d / "images") == str(d / "AllImages")
    d = hrsc_tree / "port" / "HRSC2016" / "Train"
    ds = apis.build_dataset(dict(
        type="HrscDataset", ann_file=str(d / "hrsc_train.json"),
        img_prefix=str(d / "images"), test_mode=True,
        pipeline=[dict(type="LoadImageFromFile", to_float32=True)]))
    assert ds.CLASSES == ("ship",) and len(ds) == 2
    for i in range(len(ds)):
        item = ds[i]
        want = cv2.imread(str(d / "images" / item["img_info"]["file_name"]))
        assert item["img"].dtype == np.float32
        np.testing.assert_array_equal(item["img"], want)
