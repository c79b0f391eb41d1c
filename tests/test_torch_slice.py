"""The PyTorch port's serving slice against the JAX package's, on the CPU.

An R-18 detector with narrow widths (FPN and head channels 32) at 128^2:
the JAX model's initial weights, perturbed so that the decode has work to
do (see perturb_head), go through flax_to_torch into the port.  Checked:
the head outputs, decode_detections on the same (JAX) head outputs, and
the Predictor against the JAX Predictor on the same images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.models import decode_detections as decode_ref
from orientedreppoints_tpu.ops import geometry as geo_ref
from orientedreppoints_tpu.serving import Predictor as PredictorRef
from orientedreppoints_tpu_torch.models.detector import decode_detections
from orientedreppoints_tpu_torch.ops import geometry
from orientedreppoints_tpu_torch.serving import Predictor
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_CONFIG = """
model = dict(
    type="OrientedRepPointsDetector",
    backbone=dict(type="ResNet", depth=18),
    neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
              start_level=1, add_extra_convs=True, num_outs=5),
    bbox_head=dict(type="OrientedRepPointsHead", num_classes=16,
                   in_channels=32, feat_channels=32, point_feat_channels=32,
                   stacked_convs=3, num_points=9, gradient_mul=0.3,
                   point_strides=[8, 16, 32, 64, 128]),
)
test_cfg = dict(nms_pre=100, min_bbox_size=0, score_thr=0.05,
                nms=dict(type="rnms", iou_thr=0.4), max_per_img=60,
                pre_nms_cap=256)
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
data = dict(test=dict(pipeline=[
    dict(type="LoadImageFromFile"),
    dict(type="RotateResize", img_scale=(128, 96), keep_ratio=True),
    dict(type="Normalize", **img_norm_cfg),
    dict(type="Pad", size_divisor=32),
]))
tpu = dict(canvas_buckets=[(128, 128)])
"""
DECODE = dict(nms_pre=100, score_thr=0.05, iou_thr=0.4, max_per_img=60,
              pre_nms_cap=256)


def perturb_head(variables, rng, pts_scale=300.0):
    """Random init leaves the decode idle: the cls_out prior bias scores
    every location ~0.0099 < score_thr, and std-0.01 point convs make all 9
    points coincide.  Draw cls_out's bias above the threshold and scale the
    point convs up so that the point sets spread over about a stride."""
    head = variables["params"]["bbox_head"]
    bias = head["cls_out"]["bias"]
    head["cls_out"]["bias"] = rng.uniform(-2.0, 1.0, bias.shape).astype(
        np.float32)
    for name in ("pts_init_out", "pts_refine_out"):
        head[name]["kernel"] = head[name]["kernel"] * np.float32(pts_scale)
    return variables


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny_r18.py"
    path.write_text(TINY_CONFIG)
    ref = PredictorRef(str(path), batch_size=2, compute_dtype="float32")
    variables = perturb_head(jax.tree_util.tree_map(np.array,
                                                    dict(ref.variables)),
                             np.random.default_rng(0))
    ref.variables = variables
    sd = flax_to_torch(variables)
    pred = Predictor(str(path), state_dict=sd, batch_size=2,
                     compute_dtype="float32", device="cpu")
    imgs = np.random.default_rng(1).normal(size=(2, 128, 128, 3)).astype(
        np.float32)
    outs_ref = jax.jit(ref.model.apply)(variables, imgs)
    with torch.inference_mode():
        outs = pred.model(torch.from_numpy(imgs))
    return dict(path=str(path), ref=ref, pred=pred, outs_ref=outs_ref,
                outs=outs)


@pytest.mark.parametrize("key", ["cls_scores", "pts_init", "pts_refine"])
def test_head_outputs_match(setup, key):
    for got, ref in zip(setup["outs"][key], setup["outs_ref"][key]):
        ref = np.asarray(ref)
        assert tuple(got.shape) == ref.shape
        err = np.abs(got.numpy() - ref).max()
        assert err <= 2e-4 * max(1.0, float(np.abs(ref).max())), err


def _min_area_rect_first_tie(points):
    """geometry.min_area_rect_single of the JAX package with the port's
    tie rule: boxes within a relative TIE_RTOL of the least area count as
    equal and the first hull edge wins.  Exact ties are common (three hull
    points supporting the box give two edges the same area), and in the
    JAX package rounding decides them, which would make the two decodes
    keep different, equally minimal boxes (test_torch_ops checks the rects
    themselves, ties allowed)."""
    pts = points.reshape(-1, 2).astype(jnp.float32)
    shift = jnp.mean(pts, axis=0)
    hull, hmask, hcount = geo_ref.convex_hull(pts - shift)
    idx = jnp.arange(hull.shape[0])
    nxt = jnp.where(idx >= hcount - 1, 0, idx + 1)
    edges = hull[nxt] - hull
    edge_ok = (idx < hcount) & (jnp.linalg.norm(edges, axis=-1) > 1e-9)
    theta = jnp.arctan2(edges[:, 1], edges[:, 0])
    cos_t, sin_t = jnp.cos(-theta)[:, None], jnp.sin(-theta)[:, None]
    rx = cos_t * hull[None, :, 0] - sin_t * hull[None, :, 1]
    ry = sin_t * hull[None, :, 0] + cos_t * hull[None, :, 1]
    big = jnp.where(hmask[None, :], 0.0, 1e20)
    x0, x1 = jnp.min(rx + big, 1), jnp.max(rx - big, 1)
    y0, y1 = jnp.min(ry + big, 1), jnp.max(ry - big, 1)
    areas = jnp.where(edge_ok, (x1 - x0) * (y1 - y0), jnp.inf)
    best = jnp.argmax(areas <= jnp.min(areas) * (1 + geometry.TIE_RTOL))
    rect = jnp.stack([jnp.stack([x0[best], y0[best]]),
                      jnp.stack([x1[best], y0[best]]),
                      jnp.stack([x1[best], y1[best]]),
                      jnp.stack([x0[best], y1[best]])])
    ct, st = jnp.cos(theta[best]), jnp.sin(theta[best])
    back = jnp.stack([ct * rect[:, 0] - st * rect[:, 1],
                      st * rect[:, 0] + ct * rect[:, 1]], axis=-1)
    out = jnp.where(~jnp.any(edge_ok), hull[0][None], back) + shift
    return out.reshape(8)


@pytest.fixture
def jax_ties_first(monkeypatch):
    """The JAX decode (it imports geometry.min_area_rect at trace time)
    with _min_area_rect_first_tie."""
    monkeypatch.setattr(geo_ref, "min_area_rect",
                        lambda p: jax.vmap(_min_area_rect_first_tie)(
                            p.reshape(p.shape[0], -1)))


def same_min_rect(a, b, tol=1e-3):
    """Polys (n, 8) agree within tol px, up to corner order."""
    a, b = a.reshape(-1, 4, 2), b.reshape(-1, 4, 2)
    err = np.min([np.abs(a - np.roll(bb, s, 1)).max((1, 2))
                  for bb in (b, b[:, ::-1]) for s in range(4)], 0)
    return err <= tol


def assert_dets_match(dets, labels, valid, dets_ref, labels_ref, valid_ref):
    np.testing.assert_array_equal(valid, valid_ref)
    np.testing.assert_array_equal(labels[valid], labels_ref[valid])
    d, r = dets[valid], dets_ref[valid]
    # reppoints and scores: f32 arithmetic in another order
    np.testing.assert_allclose(d[:, :18], r[:, :18], rtol=0, atol=1e-3)
    np.testing.assert_allclose(d[:, 26], r[:, 26], rtol=0, atol=1e-6)
    assert np.all(same_min_rect(d[:, 18:26], r[:, 18:26]))


def test_decode_matches_on_the_same_head_outputs(setup, jax_ties_first):
    outs_ref = setup["outs_ref"]
    ref = jax.jit(lambda o: decode_ref(o, **DECODE))(
        {k: outs_ref[k] for k in ("cls_scores", "pts_refine")})
    outs = {k: [torch.from_numpy(np.array(x)) for x in outs_ref[k]]
            for k in ("cls_scores", "pts_refine")}
    got = decode_detections(outs, **DECODE)
    dets_ref, labels_ref, valid_ref = (np.asarray(x) for x in ref)
    assert valid_ref.sum(1).min() > 10
    assert_dets_match(*(x.numpy() for x in got), dets_ref, labels_ref,
                      valid_ref)


@pytest.mark.parametrize("sizes", [
    ((96, 128), (128, 96), (60, 128)),  # fit (128, 96) at factor 1
    ((200, 150), (50, 70), (61, 143)),  # factors 0.64, 1.83, 0.895
], ids=["identity", "resize"])
def test_predictor_matches_jax_predictor(setup, jax_ties_first, sizes):
    rng = np.random.default_rng(2)
    imgs = [(rng.random((h, w, 3)) * 255).astype(np.uint8) for h, w in sizes]
    # both Predictors hand their models the same canvases and factors: the
    # port's resize is cv2's uint8 INTER_LINEAR bit for bit
    canvases, factors = setup["pred"].prepare(imgs[:2])
    for i, img in enumerate(imgs[:2]):
        canvas_ref, factor_ref = setup["ref"]._prep(img)
        np.testing.assert_array_equal(canvases[i].numpy(), canvas_ref)
        assert float(factors[i]) == np.float32(factor_ref)
    out = setup["pred"](imgs)
    ref = setup["ref"](imgs)
    assert len(out) == len(ref) == 3
    total = 0
    for per_class, per_class_ref in zip(out, ref):
        assert len(per_class) == len(per_class_ref) == 15
        for a, b in zip(per_class, per_class_ref):
            assert a.shape == b.shape
            total += len(a)
            # each framework runs its own model here: head outputs differ
            # at f32 rounding (2e-4 relative), and offsets are scaled by
            # strides up to 128 px
            np.testing.assert_allclose(a[:, 8], b[:, 8], rtol=0, atol=1e-4)
            # dets of equal score may come out in either order
            same = same_min_rect(a[:, :8], b[:, :8], tol=0.05)
            for i in np.flatnonzero(~same):
                tied = np.flatnonzero(np.abs(b[:, 8] - a[i, 8]) <= 1e-6)
                assert np.any(same_min_rect(a[i:i + 1, :8].repeat(
                    len(tied), 0), b[tied, :8], tol=0.05))
    assert total > 30
