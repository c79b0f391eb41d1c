"""The port's rebuilds of cv2's drawing, and its hard and ship-only
synthetic scenes, against cv2 5.0 and the JAX package's renderer, on the
CPU.

Each drawing primitive is held against the cv2 call it replaces on seeded
shapes, bit for bit, in float32 and float64 images (the hard scenes draw
on float64 after their brightness ramp): vertices and end points off the
image, thickness 1-3, degenerate triangles, angles at and around .5
degrees.  The hard scenes (HARD_RENDER_KWARGS) and the ship-only scenes
of the --hrsc benchmark give the JAX package's objects exactly and its
labelTxt byte for byte; their pixels differ only by cv2's IPP bicubic
(IPP_PIXELS), and with IPP off not at all.
"""

import cv2
import numpy as np
import pytest

from orientedreppoints_tpu.data import synth as synth_ref
from orientedreppoints_tpu_torch.data import synth

N_SHAPES = 400
SCENES = [(0, 256), (1, 256), (2, 256), (10000, 768)]
SHIP = {"ship": synth_ref.SYNTH_CLASS_SPECS["ship"]}
# measured over SCENES: pixels (of 786,432) one grey level off, all of
# them cv2's IPP bicubic of the background (its weights rounded
# otherwise, ~1e-6 of a value); with IPP off the scenes are equal
IPP_PIXELS = {"hard": 6, "ship": 12}
KINDS = {"hard": (synth_ref.HARD_RENDER_KWARGS, synth.HARD_RENDER_KWARGS),
         "ship": (dict(specs=SHIP), dict(specs=SHIP))}


def canvases(rng):
    """Two equal blank images of a seeded size (square or not) and dtype."""
    size = int(rng.choice([64, 100, 256]))
    shape = (size, size, 3) if rng.random() < 0.7 else (size, size // 2 + 7,
                                                        3)
    img = np.zeros(shape, rng.choice([np.float32, np.float64]))
    return img, img.copy(), size


def draw_line_case(rng, thickness):
    want, got, size = canvases(rng)
    p = rng.integers(-90, size + 90, 4)  # end points up to 90 px off
    col = tuple(rng.uniform(0, 255, 3))
    cv2.line(want, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])), col,
             thickness)
    synth.draw_line(got, p[:2], p[2:], col, thickness)
    return want, got


def ellipse_case(rng, t):
    want, got, size = canvases(rng)
    ax = int(rng.random() * 20 + 6)
    axes = (ax, int(ax * (0.4 + rng.random() * 0.5)))
    c = rng.integers(-25, size + 25, 2)  # centres up to 25 px off
    angle = rng.random() * 180
    if t % 4 == 0:  # exactly .5: cv2 rounds half to even
        angle = np.floor(angle) + 0.5
    elif t % 4 == 1:
        angle = np.floor(angle) + 0.5 + rng.choice([-1e-6, 1e-6])
    col = tuple(rng.uniform(0, 255, 3))
    cv2.ellipse(want, (int(c[0]), int(c[1])), axes, angle, 0, 360, col, -1)
    synth.fill_ellipse(got, c, axes, angle, col)
    return want, got


def triangle_case(rng, t):
    """The renderer's triangles (three points 14 px around a centre) with
    the centre up to 30 px off the image; every 5th with a repeated
    vertex, every 7th collinear, every 11th a single point."""
    want, got, size = canvases(rng)
    c = rng.uniform(-30, size + 30, 2)
    pts = (np.stack([c] * 3) + rng.normal(size=(3, 2)) * 14).astype(np.int32)
    if t % 5 == 0:
        pts[2] = pts[0]
    if t % 7 == 0:
        pts[2] = 2 * pts[1] - pts[0]
    if t % 11 == 0:
        pts[:] = pts[0]
    col = tuple(rng.uniform(0, 255, 3))
    cv2.fillPoly(want, [pts], col)
    synth.fill_poly(got, pts, col)
    return want, got


def polygon_case(rng, fill):
    """3-6 vertices anywhere within 40 px of the image, convex or not."""
    want, got, size = canvases(rng)
    pts = rng.integers(-40, size + 40, (int(rng.integers(3, 7)), 2)).astype(
        np.int32)
    col = tuple(rng.uniform(0, 255, 3))
    if fill:
        cv2.fillPoly(want, [pts], col)
        synth.fill_poly(got, pts, col)
    else:
        cv2.polylines(want, [pts], True, col, 1)
        synth.polylines(got, pts, col)
    return want, got


CASES = {
    "line_t1": lambda rng, t: draw_line_case(rng, 1),
    "line_t2": lambda rng, t: draw_line_case(rng, 2),
    "line_t3": lambda rng, t: draw_line_case(rng, 3),
    "ellipse": ellipse_case,
    "triangle": triangle_case,
    "polygon": lambda rng, t: polygon_case(rng, True),
    "polylines": lambda rng, t: polygon_case(rng, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_primitive_equals_cv2(case):
    """N_SHAPES seeded shapes, each image equal to cv2's bit for bit."""
    rng = np.random.default_rng(list(CASES).index(case))
    drawn = 0
    for t in range(N_SHAPES):
        want, got = CASES[case](rng, t)
        np.testing.assert_array_equal(got, want, err_msg=f"{case} #{t}")
        drawn += bool(want.any())
    assert drawn > N_SHAPES // 4  # most shapes reach the image


def test_ellipse_angle_rounds_to_whole_degrees():
    """cv2 rounds the angle (half to even): 10.4 draws as 10, 10.6 as 11,
    10.5 as 10 and 11.5 as 12."""
    def draw(angle):
        img = np.zeros((64, 64, 3), np.float32)
        synth.fill_ellipse(img, (32, 30), (25, 10), angle, (1.0, 1.0, 1.0))
        ref = np.zeros_like(img)
        cv2.ellipse(ref, (32, 30), (25, 10), angle, 0, 360, (1.0, 1.0, 1.0),
                    -1)
        np.testing.assert_array_equal(img, ref)
        return img

    assert np.array_equal(draw(10.0), draw(10.4))
    assert not np.array_equal(draw(10.4), draw(10.6))
    assert np.array_equal(draw(11.0), draw(10.6))
    assert np.array_equal(draw(10.5), draw(10.0))
    assert np.array_equal(draw(11.5), draw(12.0))


def test_thick_lines_cover_more_than_thin_ones():
    """One 51-px segment at thickness 1, 2 and 3 (cv2: a quad with round
    caps above 1)."""
    counts = []
    for t in (1, 2, 3):
        img = np.zeros((64, 64, 3), np.float32)
        synth.draw_line(img, (5, 10), (55, 30), (1.0, 1.0, 1.0), t)
        ref = np.zeros_like(img)
        cv2.line(ref, (5, 10), (55, 30), (1.0, 1.0, 1.0), t)
        np.testing.assert_array_equal(img, ref)
        counts.append(int(img[..., 0].sum()))
    assert counts[0] == 51 and counts[0] < counts[1] < counts[2]


def scene_pair(kind, seed, size):
    ref_kw, kw = KINDS[kind]
    a, objs_a = synth_ref.render_scene(np.random.RandomState(seed), size=size,
                                       **ref_kw)
    b, objs_b = synth.render_scene(np.random.RandomState(seed), size=size,
                                   **kw)
    return a, objs_a, b, objs_b


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("seed, size", SCENES)
def test_scene_objects_equal(kind, seed, size):
    _, objs_a, img, objs_b = scene_pair(kind, seed, size)
    assert img.shape == (size, size, 3) and img.dtype == np.uint8
    assert len(objs_a) == len(objs_b) >= 10
    names = {"hard": set(synth.SYNTH_HARD_CLASS_SPECS), "ship": {"ship"}}
    for a, b in zip(objs_a, objs_b):
        assert a["name"] == b["name"] and a["difficult"] == b["difficult"]
        assert b["name"] in names[kind]
        np.testing.assert_array_equal(a["poly"], b["poly"])


@pytest.mark.parametrize("kind", list(KINDS))
def test_scene_pixels(kind):
    """At most IPP_PIXELS[kind] pixels one grey level off over SCENES, and
    none with cv2's IPP off."""
    differ = 0
    ipp = cv2.ipp.useIPP()
    for seed, size in SCENES:
        a, _, b, _ = scene_pair(kind, seed, size)
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
        assert diff.max() <= 1
        differ += int((diff > 0).sum())
        try:
            cv2.ipp.setUseIPP(False)
            a, _, b, _ = scene_pair(kind, seed, size)
        finally:
            cv2.ipp.setUseIPP(ipp)
        np.testing.assert_array_equal(a, b)
    assert differ <= IPP_PIXELS[kind], differ


def test_ship_scenes_write_the_jax_tools_labels(tmp_path, monkeypatch):
    """generate_synth_dota(specs=ship) against the JAX tool's --hrsc
    scenes (render_scene patched to the ship specs), easy and hard:
    labelTxt byte for byte."""
    orig = synth_ref.render_scene

    def ship_render(rng, **kw):
        kw["specs"] = SHIP
        return orig(rng, **kw)

    monkeypatch.setattr(synth_ref, "render_scene", ship_render)
    for hard in (False, True):
        ref, port = tmp_path / f"ref{hard}", tmp_path / f"port{hard}"
        names = synth_ref.generate_synth_dota(str(ref), 2, size=256, seed=3,
                                              prefix="V", hard=hard)
        assert synth.generate_synth_dota(str(port), 2, size=256, seed=3,
                                         prefix="V", hard=hard,
                                         specs=SHIP) == names
        for n in names:
            lab = (port / "labelTxt" / f"{n}.txt").read_bytes()
            assert lab == (ref / "labelTxt" / f"{n}.txt").read_bytes()
            assert lab.count(b" ship 0\n") == lab.count(b"\n") >= 5
