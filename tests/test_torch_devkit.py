"""The port's DOTA devkit (orientedreppoints_tpu_torch/devkit, core/rbox)
and its evaluate_results against the JAX package's, on the CPU.

The same seeded numpy inputs and files go through both.  Both sides are
float64 numpy with the same arithmetic in the same order, so every result
is compared exactly (geometry, AP, mAP and mAOE) or byte for byte (Task1
and merged files).
"""

import os
import os.path as osp

import numpy as np
import pytest

from orientedreppoints_tpu import apis as apis_ref
from orientedreppoints_tpu.core import rbox as rbox_ref
from orientedreppoints_tpu.devkit import dota_utils as util_ref
from orientedreppoints_tpu.devkit import evaluation as eval_ref
from orientedreppoints_tpu.devkit import polygon as pg_ref
from orientedreppoints_tpu.devkit import result_merge as merge_ref
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.core import rbox
from orientedreppoints_tpu_torch.data.dota import DOTA_CLASSES
from orientedreppoints_tpu_torch.devkit import dota_utils as util
from orientedreppoints_tpu_torch.devkit import evaluation
from orientedreppoints_tpu_torch.devkit import polygon as pg
from orientedreppoints_tpu_torch.devkit import result_merge

CLASSES = ("plane", "ship", "storage-tank")


def rect(cx, cy, w, h, a):
    c, s = np.cos(a), np.sin(a)
    r = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2],
                  [-w / 2, h / 2]])
    return (r @ np.array([[c, s], [-s, c]]) + [cx, cy]).reshape(-1)


def quads(rng, n, lo=0.0, hi=300.0):
    return np.array([rect(*rng.uniform(lo, hi, 2), *rng.uniform(5, 60, 2),
                          rng.uniform(0, np.pi))
                     for _ in range(n)]).reshape(n, 8)


SQUARE = np.array([0.0, 0, 10, 0, 10, 10, 0, 10])
PAIRS = {
    "hbb_disjoint": (SQUARE, SQUARE + 30.0),
    "touching": (SQUARE, SQUARE + np.array([10.0, 0] * 4)),
    "nested": (SQUARE, np.array([2.0, 2, 8, 2, 8, 8, 2, 8])),
    "rotated_in_square": (SQUARE, rect(5, 5, 6, 6, 0.7)),
    "clockwise": (SQUARE[[6, 7, 4, 5, 2, 3, 0, 1]], rect(8, 3, 9, 4, 0.3)),
    "degenerate": (SQUARE, np.tile([3.0, 3.0], 4)),
}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_poly_iou_special_pairs(pair):
    a, b = PAIRS[pair]
    assert pg.poly_iou(a, b) == pg_ref.poly_iou(a, b)
    assert pg.poly_iou(b, a) == pg_ref.poly_iou(b, a)


def test_poly_iou_matrix_matches():
    """Pair by pair against JAX's numpy poly_iou: JAX's poly_iou_matrix
    goes through csrc/build/libpolyiou.so wherever setup_native.py built
    it, and that library's fused multiply-adds round otherwise."""
    rng = np.random.default_rng(0)
    a, b = quads(rng, 30, hi=120), quads(rng, 25, hi=120)
    got = pg.poly_iou_matrix(a, b)
    ref = np.array([[pg_ref.poly_iou(x, y) for y in b] for x in a])
    assert (ref > 0).sum() > 50
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["random", "special", "tied_scores"])
def test_poly_nms_matches(case):
    rng = np.random.default_rng(1)
    if case == "special":
        polys = np.concatenate([np.stack(p) for p in PAIRS.values()])
        scores = rng.uniform(0, 1, len(polys))
    else:
        base = quads(rng, 60, hi=200)
        polys = np.concatenate([base, base + rng.normal(0, 3, base.shape)])
        scores = rng.uniform(0, 1, len(polys))
        if case == "tied_scores":
            scores = np.round(scores * 4) / 4
    dets = np.concatenate([polys, scores[:, None]], 1)
    for thr in (0.1, 0.4):
        keep = pg.poly_nms(dets, thr)
        assert keep == pg_ref.poly_nms(dets, thr)
        assert 0 < len(keep) < len(dets)


@pytest.mark.parametrize("case", ["random", "near_square"])
def test_poly2rbox_v3_matches(case):
    rng = np.random.default_rng(2)
    polys = quads(rng, 200)
    if case == "near_square":
        # edge ratios around 1.15, where v3 picks the smaller |angle|
        polys = np.stack([rect(50, 50, *(20 * rng.uniform(1, 1.3, 2)),
                               rng.uniform(0, np.pi)) for _ in range(200)])
    np.testing.assert_array_equal(rbox.poly2rbox_v3(polys),
                                  rbox_ref.poly2rbox_v3(polys))


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_matches(use_07):
    rng = np.random.default_rng(3)
    for _ in range(20):
        tp = rng.random(40) < 0.6
        rec = np.cumsum(tp) / 50.0
        prec = np.cumsum(tp) / np.arange(1, 41)
        assert evaluation.voc_ap(rec, prec, use_07) == \
            eval_ref.voc_ap(rec, prec, use_07)


def test_dota_utils_match(tmp_path):
    assert util.DOTA10_CLASSES == util_ref.DOTA10_CLASSES == DOTA_CLASSES
    p = tmp_path / "a.txt"
    p.write_text("imagesource:GoogleEarth\ngsd:0.1\n"
                 "1 2 3 4 5 6 7 8 plane 0\n1.5 2 3 4 5 6 7 8.25 ship\n"
                 "short line\n")
    got, ref = util.parse_dota_poly(str(p)), util_ref.parse_dota_poly(str(p))
    assert [(o["name"], o["difficult"]) for o in got] == \
        [(o["name"], o["difficult"]) for o in ref] == [("plane", "0"),
                                                        ("ship", "0")]
    for o, r in zip(got, ref):
        np.testing.assert_array_equal(o["poly"], r["poly"])
        assert util.poly_area(o["poly"]) == util_ref.poly_area(r["poly"])
    assert util.parse_dota_poly(str(tmp_path / "missing.txt")) == []
    for name in ("P0001__1.0__0___824", "P0002__0.5__1024___0"):
        assert util.parse_tile_name(name) == util_ref.parse_tile_name(name)
    util.write_dota_poly(str(tmp_path / "w1.txt"), got)
    util_ref.write_dota_poly(str(tmp_path / "w2.txt"), ref)
    assert (tmp_path / "w1.txt").read_bytes() == \
        (tmp_path / "w2.txt").read_bytes()


def eval_case(root, seed=4):
    """labelTxt for 5 images (one without a file) and per-class Task1
    files: gts jittered (most above IoU 0.5, some between 0.5 and 0.7 for
    mAOE's threshold), false positives, duplicates of matched gts, tied
    scores, dets of images without gts, and difficult '1' / '2' gts."""
    rng = np.random.default_rng(seed)
    anno = osp.join(root, "labelTxt")
    det = osp.join(root, "det")
    os.makedirs(anno)
    os.makedirs(det)
    names = [f"I{i}" for i in range(5)]
    lines = {c: [] for c in CLASSES}
    for ii, name in enumerate(names):
        objs = []
        for k in range(12):
            c = CLASSES[rng.integers(len(CLASSES))]
            square = c == "storage-tank"
            w = rng.uniform(15, 60)
            poly = rect(*rng.uniform(40, 460, 2), w,
                        w * (rng.uniform(1, 1.1) if square
                             else rng.uniform(0.2, 0.6)),
                        rng.uniform(0, np.pi))
            objs.append(dict(poly=poly, name=c,
                             difficult=str(rng.choice(["0", "0", "0", "1",
                                                       "2"]))))
            if rng.random() < 0.8:
                d = poly + rng.normal(0, rng.choice([0.5, 3.0]), 8)
                lines[c].append((name, np.round(rng.random(), 2), d))
                if rng.random() < 0.2:  # a duplicate of a matched gt
                    lines[c].append((name, np.round(rng.random(), 2),
                                     d + 0.5))
        if ii != 4:  # I4 has no labelTxt
            util_ref.write_dota_poly(osp.join(anno, name + ".txt"), objs)
        for _ in range(5):  # false positives
            c = CLASSES[rng.integers(len(CLASSES))]
            lines[c].append((name, np.round(rng.random(), 2),
                             rect(*rng.uniform(0, 500, 2), 20, 10, 0.3)))
    lines["ship"].append(("unknown", 0.9, rect(50, 50, 20, 10, 0.1)))
    for c, rows in lines.items():
        with open(osp.join(det, f"Task1_{c}.txt"), "w") as f:
            for name, s, d in rows:
                f.write(f"{name} {s} " + " ".join(str(v) for v in d) + "\n")
    return (osp.join(det, "Task1_{:s}.txt"), osp.join(anno, "{:s}.txt"),
            names)


@pytest.mark.parametrize("use_07", [True, False])
def test_eval_dota_task1_matches(tmp_path, use_07):
    detpath, annopath, names = eval_case(str(tmp_path))
    got = evaluation.eval_dota_task1(detpath, annopath, names, CLASSES,
                                     use_07_metric=use_07)
    ref = eval_ref.eval_dota_task1(detpath, annopath, names, CLASSES,
                                   use_07_metric=use_07)
    assert got == ref
    assert 0.2 < got[0] < 1.0


def test_eval_task1_image_set_file(tmp_path):
    detpath, annopath, names = eval_case(str(tmp_path), seed=5)
    setfile = tmp_path / "set.txt"
    setfile.write_text("\n".join(names[:3]) + "\n\n")
    assert evaluation.eval_dota_task1(detpath, annopath, str(setfile),
                                      CLASSES) == \
        eval_ref.eval_dota_task1(detpath, annopath, str(setfile), CLASSES)


@pytest.mark.parametrize("ovthresh", [0.5, 0.7])
def test_eval_maoe_matches(tmp_path, ovthresh):
    detpath, annopath, names = eval_case(str(tmp_path))
    got = evaluation.eval_maoe(detpath, annopath, names, CLASSES,
                               ovthresh=ovthresh, return_mod90=True)
    ref = eval_ref.eval_maoe(detpath, annopath, names, CLASSES,
                             ovthresh=ovthresh, return_mod90=True)
    assert got == ref
    assert len(got[1]) == len(CLASSES) and got[0] > 0
    assert evaluation.eval_maoe(detpath, annopath, names, CLASSES,
                                ovthresh=ovthresh) == got[:2]


def test_eval_without_detections(tmp_path):
    _, annopath, names = eval_case(str(tmp_path))
    empty = str(tmp_path / "none_{:s}.txt")
    assert evaluation.eval_dota_task1(empty, annopath, names, CLASSES) == \
        eval_ref.eval_dota_task1(empty, annopath, names, CLASSES)
    assert evaluation.eval_maoe(empty, annopath, names, CLASSES,
                                return_mod90=True) == (0.0, {}, 0.0, {})


def tile_results(rng, names, k=40):
    """{tile name: [per-class (k_c, 9 or 27) float32 arrays]} over 15
    classes, empty classes included; 27-wide rows carry reppoints."""
    results = {}
    for ti, name in enumerate(names):
        per_class = []
        for c in range(15):
            n = int(rng.integers(0, k)) if c < 4 else 0
            polys = quads(rng, n, hi=512).reshape(n, 8)
            rows = np.concatenate([polys, rng.random((n, 1))], 1)
            if ti % 2:
                rows = np.concatenate([rng.random((n, 18)) * 512, rows], 1)
            per_class.append(rows.astype(np.float32))
        results[name] = per_class
    return results


def test_write_task1_results_byte_equal(tmp_path):
    rng = np.random.default_rng(6)
    results = tile_results(rng, ["V0000__1.0__0___0", "V0000__1.0__256___0",
                                 "V0001__1.0__0___256"])
    result_merge.write_task1_results(results, DOTA_CLASSES,
                                     str(tmp_path / "a"))
    merge_ref.write_task1_results(results, DOTA_CLASSES, str(tmp_path / "b"))
    for c in DOTA_CLASSES:
        got = (tmp_path / "a" / f"Task1_{c}.txt").read_bytes()
        assert got == (tmp_path / "b" / f"Task1_{c}.txt").read_bytes()
    assert (tmp_path / "a" / "Task1_plane.txt").stat().st_size > 0


def merge_case(tmp_path):
    """Task1 files of the tiles of two scenes at offsets 0 / 256, dets
    duplicated across overlapping tiles (shifted into each tile's frame,
    jittered) -> (their folder, the number of dets)."""
    rng = np.random.default_rng(7)
    tiles = [(s, left, up) for s in ("V0000", "V0001")
             for left in (0, 256) for up in (0, 256)]
    names = [f"{s}__1.0__{left}___{up}" for s, left, up in tiles]
    results = tile_results(rng, names)
    # the same scene objects seen from two tiles
    for ci in range(4):
        scene = quads(rng, 10, lo=260, hi=500)
        for name, (_, left, up) in zip(names, tiles):
            shifted = scene - np.array([left, up] * 4)
            rows = np.concatenate(
                [shifted + rng.normal(0, 1, shifted.shape),
                 rng.random((10, 1))], 1).astype(np.float32)
            if results[name][ci].shape[1] == 27:
                rows = np.concatenate([np.zeros((10, 18), np.float32), rows],
                                      1)
            results[name][ci] = np.concatenate([results[name][ci], rows])
    src = str(tmp_path / "raw")
    result_merge.write_task1_results(results, DOTA_CLASSES, src)
    return src, sum(len(a) for r in results.values() for a in r)


def assert_same_files(a, b):
    """Every Task1 file of folder a equals b's byte for byte -> lines."""
    total = 0
    for c in DOTA_CLASSES:
        got = (a / f"Task1_{c}.txt").read_bytes()
        assert got == (b / f"Task1_{c}.txt").read_bytes(), c
        total += got.count(b"\n")
    return total


@pytest.mark.parametrize("thresh", [0.1, 0.3, 0.5])
def test_merge_by_poly_byte_equal(tmp_path, thresh):
    """The tiles merged back into their scenes and NMSed per scene."""
    src, n = merge_case(tmp_path)
    result_merge.merge_by_poly(src, str(tmp_path / "a"), thresh)
    merge_ref.merge_by_poly(src, str(tmp_path / "b"), thresh, num_process=1)
    assert 100 < assert_same_files(tmp_path / "a", tmp_path / "b") < n


@pytest.mark.parametrize("workers", [2, 3])
def test_merge_by_poly_pool_byte_equal(tmp_path, workers):
    """The class files merged by a spawn pool of 2 and 3 workers (the
    largest file first): JAX's one-process merge, byte for byte."""
    src, n = merge_case(tmp_path)
    result_merge.merge_by_poly(src, str(tmp_path / "a"),
                               num_process=workers)
    merge_ref.merge_by_poly(src, str(tmp_path / "b"), num_process=1)
    assert 100 < assert_same_files(tmp_path / "a", tmp_path / "b") < n


def test_merge_by_poly_signature():
    """JAX's parameters and defaults: nms_thresh 0.1, 16 processes."""
    import inspect

    got = inspect.signature(result_merge.merge_by_poly).parameters
    want = inspect.signature(merge_ref.merge_by_poly).parameters
    assert [(k, p.default) for k, p in got.items()] == [
        (k, p.default) for k, p in want.items()]
    assert got["num_process"].default == 16


class StubDataset:
    """The two attributes evaluate_results reads, for three tiles."""
    CLASSES = DOTA_CLASSES

    def __init__(self, rng, labelled=True):
        self.img_infos = [dict(file_name=f"t{i}.npy") for i in range(3)]
        self.anns = []
        for _ in range(3):
            n = 6 if labelled else 0
            self.anns.append(dict(
                bboxes=quads(rng, n, hi=120).reshape(n, 8).astype(np.float32),
                labels=rng.integers(1, 4, n),
                difficult=(rng.random(n) < 0.2).astype(np.int64)))


def stub_results(rng, dataset, names):
    """Dets near each tile's gts (jittered) plus false positives."""
    out = {}
    for name in names:
        ann = dataset.anns[int(name[1:])]
        per_class = []
        for ci in range(15):
            gts = ann["bboxes"][ann["labels"] == ci + 1]
            rows = np.concatenate([gts + rng.normal(0, 2, gts.shape),
                                   quads(rng, 2, hi=120)])
            per_class.append(np.concatenate(
                [rows, rng.random((len(rows), 1))], 1).astype(np.float32))
        out[name] = per_class
    return out


def assert_same_eval(got, ref):
    """(mAP, {class: ap}) equal, a class without gts nan in both."""
    assert got[0] == ref[0]
    assert got[1].keys() == ref[1].keys()
    for k in got[1]:
        assert got[1][k] == ref[1][k] or (np.isnan(got[1][k])
                                          and np.isnan(ref[1][k])), k


@pytest.mark.parametrize("use_07", [True, False])
def test_evaluate_results_matches_jax(use_07):
    rng = np.random.default_rng(8)
    ds = StubDataset(rng)
    results = stub_results(rng, ds, ["t0", "t1", "t2"])
    got = apis.evaluate_results(results, ds, use_07_metric=use_07)
    assert_same_eval(got, apis_ref.evaluate_results(
        results, ds, use_07_metric=use_07))
    assert 0 < got[0] < 1


def test_evaluate_results_scores_only_inferred_tiles():
    """The reference's subset scoring (apis.py:317-321), kept: the gts of
    tiles absent from results are not counted as misses, so scoring t0
    alone equals scoring a dataset that holds only t0."""
    rng = np.random.default_rng(9)
    ds = StubDataset(rng)
    results = stub_results(rng, ds, ["t0"])
    got = apis.evaluate_results(results, ds)
    assert_same_eval(got, apis_ref.evaluate_results(results, ds))
    alone = StubDataset(rng)
    alone.img_infos, alone.anns = ds.img_infos[:1], ds.anns[:1]
    assert_same_eval(apis.evaluate_results(results, alone), got)
    # scoring all three tiles charges t1's and t2's gts as misses
    results_all = dict(results, t1=[np.zeros((0, 9), np.float32)] * 15,
                       t2=[np.zeros((0, 9), np.float32)] * 15)
    assert apis.evaluate_results(results_all, ds)[0] < got[0]


def test_evaluate_results_without_gts_raises():
    rng = np.random.default_rng(10)
    ds = StubDataset(rng, labelled=False)
    results = stub_results(rng, StubDataset(rng), ["t0", "t1"])
    with pytest.raises(ValueError, match="no ground-truth"):
        apis.evaluate_results(results, ds)
    with pytest.raises(ValueError, match="no ground-truth"):
        apis_ref.evaluate_results(results, ds)
