"""The port's host library of quad IoUs (csrc/polyiou.cpp through
devkit/native.py) against the JAX package's numpy poly_iou, on the CPU.

Every IoU must equal JAX's numpy poly_iou bit for bit: 21,000 seeded
pairs of rotated rectangles (near, crossing at ~45 degrees so that the
intersection is an octagon, identical, touching, nested, zero-area,
clockwise) and of arbitrary quads.  Not JAX's poly_iou_matrix: it goes
through csrc/build/libpolyiou.so wherever setup_native.py built it, whose
fused multiply-adds round otherwise.  poly_nms and soft_poly_nms (linear,
gaussian, original), which now make one library call a pick, keep JAX's
picks and scores exactly; the merge's files equal JAX's byte for byte.
The library builds at first use, two processes building at once both
load a whole one, a failed build raises, and the loader imports no torch.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from orientedreppoints_tpu.devkit import polygon as pg_ref
from orientedreppoints_tpu.devkit import result_merge as merge_ref
from orientedreppoints_tpu_torch.data.dota import DOTA_CLASSES
from orientedreppoints_tpu_torch.devkit import native
from orientedreppoints_tpu_torch.devkit import polygon as pg
from orientedreppoints_tpu_torch.devkit import result_merge
from test_torch_devkit import PAIRS, assert_same_files, quads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAIRS = 21000


def rects(rng, n, centre=None, side=None, angle=None):
    """(n, 8) rotated rectangles: centres in [0, 100)^2, sides 1-60."""
    c = rng.uniform(0, 100, (n, 2)) if centre is None else centre
    w, h = (rng.uniform(1, 60, n), rng.uniform(1, 60, n)) if side is None \
        else side
    a = rng.uniform(-np.pi, np.pi, n) if angle is None else angle
    d = np.stack([np.cos(a), np.sin(a)], 1)
    e = np.stack([-np.sin(a), np.cos(a)], 1)
    corners = [c + (sx * w / 2)[:, None] * d + (sy * h / 2)[:, None] * e
               for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
    return np.stack(corners, 1).reshape(n, 8)


def pair_sets(rng):
    """name -> (a (n, 8), b (n, 8))."""
    sets = {}
    a = rects(rng, 9000)
    b = rects(rng, 9000)
    mid = lambda q: q.reshape(-1, 4, 2).mean(1)  # noqa: E731
    b = (b.reshape(-1, 4, 2) - mid(b)[:, None]
         + mid(a)[:, None] + rng.normal(0, 8, (9000, 1, 2))).reshape(-1, 8)
    sets["near"] = (a, b)
    n = 4000
    c = rng.uniform(0, 100, (n, 2))
    s = rng.uniform(5, 40, n)
    t = rng.uniform(0, np.pi, n)
    sets["octagon"] = (
        rects(rng, n, c, (s, s), t),
        rects(rng, n, c + rng.normal(0, 0.05, (n, 2)),
              (s * rng.uniform(0.97, 1.03, n),) * 2,
              t + np.pi / 4 + rng.normal(0, 0.05, n)))
    a = rects(rng, 1500)
    sets["identical"] = (a, a.copy())
    q = a.reshape(-1, 4, 2)
    sets["touching"] = (a, (q + (q[:, 1] - q[:, 0])[:, None]).reshape(-1, 8))
    sets["nested"] = (a, ((q - q.mean(1, keepdims=True)) * 0.5
                          + q.mean(1, keepdims=True)).reshape(-1, 8))
    pt = rng.uniform(0, 100, (1500, 1, 2))
    line = pt + rng.uniform(0, 1, (1500, 4, 1)) * rng.normal(0, 20,
                                                           (1500, 1, 2))
    sets["zero_area"] = (a, np.where(np.arange(1500)[:, None, None] % 2,
                                     pt.repeat(4, 1), line).reshape(-1, 8))
    sets["clockwise"] = (q[:, ::-1].reshape(-1, 8), rects(rng, 1500))
    sets["arbitrary"] = (rng.uniform(0, 50, (1000, 8)),
                         rng.uniform(0, 50, (1000, 8)))
    return sets


@pytest.fixture(scope="module")
def pairs():
    sets = pair_sets(np.random.default_rng(0))
    assert sum(len(a) for a, _ in sets.values()) >= N_PAIRS
    return sets


def test_pairs_equal_numpy_bit_for_bit(pairs):
    """Each pair's IoU is JAX's numpy poly_iou's, bit for bit; octagons
    (8-vertex intersections, where numpy's sum takes its pairwise order)
    occur among them."""
    total = 0
    for name, (a, b) in pairs.items():
        got = native.poly_iou_pairs(a, b)
        want = np.array([pg_ref.poly_iou(x, y) for x, y in zip(a, b)])
        np.testing.assert_array_equal(got.view(np.int64),
                                      want.view(np.int64), err_msg=name)
        total += len(a)
    assert total >= N_PAIRS
    a, b = pairs["octagon"]
    verts = [len(pg_ref.clip_polygon_poly(pg_ref.orient_ccw(x.reshape(4, 2)),
                                          pg_ref.orient_ccw(y.reshape(4, 2))))
             for x, y in zip(a[:400], b[:400])]
    assert np.bincount(verts)[8] >= 100
    assert (native.poly_iou_pairs(*pairs["identical"]) == 1.0).mean() > 0.9
    # a collinear quad's area is its terms' rounding, ~1e-14 of a side^2
    assert np.abs(native.poly_iou_pairs(*pairs["zero_area"])).max() < 1e-9


def test_entries_agree(pairs):
    """one_many and the matrix give the pairs' IoUs; one quad against
    many through poly_iou_pairs too."""
    a, b = (x[:300] for x in pairs["near"])
    m = native.poly_iou_matrix(a, b)
    np.testing.assert_array_equal(np.diag(m), native.poly_iou_pairs(a, b))
    np.testing.assert_array_equal(native.poly_iou_one_many(a[7], b), m[7])
    np.testing.assert_array_equal(native.poly_iou_pairs(b, a[7]),
                                  [pg_ref.poly_iou(y, a[7]) for y in b])
    np.testing.assert_array_equal(pg.poly_iou_matrix(a[:20], b[:30]),
                                  m[:20, :30])
    assert native.poly_iou_one_many(a[0], np.zeros((0, 8))).shape == (0,)


def nms_sets(rng):
    base = quads(rng, 150, hi=300)
    polys = np.concatenate([base, base + rng.normal(0, 3, base.shape),
                            base + rng.normal(0, 8, base.shape)])
    special = np.concatenate([np.stack(p) for p in PAIRS.values()]
                             + [np.full((1, 8), np.nan)])
    scores = rng.uniform(0, 1, len(polys))
    return {"random": (polys, scores),
            "tied_scores": (polys, np.round(scores * 4) / 4),
            "special": (special, rng.uniform(0, 1, len(special)))}


@pytest.mark.parametrize("case", ["random", "tied_scores", "special"])
def test_poly_nms_equals_jax(case):
    polys, scores = nms_sets(np.random.default_rng(3))[case]
    dets = np.concatenate([polys, scores[:, None]], 1)
    for thr in (0.1, 0.3, 0.6):
        keep = pg.poly_nms(dets, thr)
        assert keep == pg_ref.poly_nms(dets, thr)
        assert 0 < len(keep) < len(dets)


@pytest.mark.parametrize("method", ["linear", "gaussian", "original"])
@pytest.mark.parametrize("case", ["random", "tied_scores", "special"])
def test_soft_poly_nms_equals_jax(case, method):
    polys, scores = nms_sets(np.random.default_rng(4))[case]
    dets = np.concatenate([polys, scores[:, None]], 1)[:120]
    got = pg.soft_poly_nms(dets, 0.3, method=method, min_score=0.05)
    ref = pg_ref.soft_poly_nms(dets, 0.3, method=method, min_score=0.05)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0].view(np.int64),
                                  ref[0].view(np.int64))
    assert 0 < len(ref[1]) < len(dets)


def test_exp_over_an_array_equals_scalar_calls():
    """soft_poly_nms's gaussian decay takes np.exp over a pick's IoUs at
    once, where JAX calls it on each IoU."""
    rng = np.random.default_rng(5)
    iou = np.concatenate([rng.uniform(0, 1, 100003), [0.0, 1.0]])
    for sigma in (0.5, 0.3, 0.1):
        x = -(iou * iou) / sigma
        scalars = np.array([np.exp(-(float(v) * float(v)) / sigma)
                            for v in iou])
        np.testing.assert_array_equal(np.exp(x).view(np.int64),
                                      scalars.view(np.int64))


def test_merge_files_equal_jax(tmp_path):
    """A dense class file (2,400 dets over two scenes, each object seen
    by four tiles) merged by the port, in one process and by a pool,
    byte for byte as JAX's one-process merge."""
    rng = np.random.default_rng(8)
    tiles = [(s, left, up) for s in ("V0000", "V0001")
             for left in (0, 256) for up in (0, 256)]
    results = {}
    for ci, cname in enumerate(DOTA_CLASSES[:2]):
        scene = {s: quads(rng, 150, lo=200, hi=560) for s in ("V0000",
                                                                "V0001")}
        for s, left, up in tiles:
            name = f"{s}__1.0__{left}___{up}"
            rows = scene[s] - np.array([left, up] * 4)
            rows = np.concatenate([rows + rng.normal(0, 1.5, rows.shape),
                                   rng.random((len(rows), 1))], 1)
            results.setdefault(name, [np.zeros((0, 9), np.float32)] *
                               len(DOTA_CLASSES))[ci] = rows.astype(
                np.float32)
    src = str(tmp_path / "raw")
    result_merge.write_task1_results(results, DOTA_CLASSES, src)
    merge_ref.merge_by_poly(src, str(tmp_path / "ref"), num_process=1)
    result_merge.merge_by_poly(src, str(tmp_path / "one"), num_process=1)
    result_merge.merge_by_poly(src, str(tmp_path / "pool"), num_process=2)
    lines = assert_same_files(tmp_path / "one", tmp_path / "ref")
    assert assert_same_files(tmp_path / "pool", tmp_path / "ref") == lines
    assert 300 < lines < 2400


BUILD_SCRIPT = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    from orientedreppoints_tpu_torch.devkit import native, result_merge
    native.BUILD_ROOT = Path(sys.argv[1])
    time.sleep(max(0.0, float(sys.argv[2]) - time.time()))
    path, secs = native.build()
    sq = [0.0, 0, 10, 0, 10, 10, 0, 10]
    iou = native.poly_iou_pairs([sq], [[5.0, 0, 15, 0, 15, 10, 5, 10]])[0]
    print(path, secs > 0, iou, "torch" in sys.modules)
""")


def test_two_processes_build_at_once(tmp_path):
    """Two processes start the same build at the same moment: each
    writes its own file and renames it into place, so both load a whole
    library; nothing but the library is left."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    start = str(time.time() + 3.0)
    cmd = [sys.executable, "-c", BUILD_SCRIPT, str(tmp_path), start]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        path, built, iou, torch_loaded = out.split()
        assert built in ("True", "False")
        assert float(iou) == pg_ref.poly_iou([0.0, 0, 10, 0, 10, 10, 0, 10],
                                             [5.0, 0, 15, 0, 15, 10, 5, 10])
        assert torch_loaded == "False"  # the merge's workers stay light
    lib = native.lib_path().name
    left = [f.name for d in tmp_path.iterdir() for f in d.iterdir()]
    assert left == [lib]


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "polyiou.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.lib()
