"""The PyTorch port's TTA test path and quad-IoU entries against the JAX
package, on the CPU.

Seeded numpy inputs go through the JAX function and its port (plain
versions: the tensors are on the CPU).  The JAX quad-IoU entries run as the
JAX package's own tests run them: through their XLA fallback, or in
interpret mode (ORP_FORCE_PALLAS_INTERPRET=1).  Checked: quad_iou_matrix /
quad_iou_matrix_batch with and without upper_tri, box_iou_rotated,
soft_rnms, rotated_nms_mask, multiclass_rnms, decode_no_nms +
merge_aug_and_nms, the scale-canvas resize against cv2, and
run_inference_tta on a tiny R-18 against the JAX model.apply +
decode_no_nms + merge_aug_and_nms; the identity aug against the port's
run_inference.  Tolerances are stated per test.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu import apis as apis_ref
from orientedreppoints_tpu.models import OrientedRepPointsDetector
from orientedreppoints_tpu.models import detector as detector_ref
from orientedreppoints_tpu.ops import geometry as geo_ref
from orientedreppoints_tpu.ops import nms as nms_ref
from orientedreppoints_tpu.ops import pallas_quad_iou
from orientedreppoints_tpu_torch import apis, host
from orientedreppoints_tpu_torch.apis import build_detector
from orientedreppoints_tpu_torch.models import detector
from orientedreppoints_tpu_torch.ops import geometry, nms, quad_iou
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_torch_ops import class_offset_quads
from test_torch_slice import (_min_area_rect_first_tie, perturb_head,
                              same_min_rect)
from test_torch_train import jax_fast_compile

WIDTH = 32
CANVAS = (128, 128)
TC = dict(nms_pre=100, score_thr=0.05, nms=dict(iou_thr=0.4),
          max_per_img=60, pre_nms_cap=256)
AUGS = [(0.5, False), (0.5, True), (1.0, False), (1.0, True), (1.5, False),
        (1.5, True)]


def fast_jit(fn):
    """jax.jit(fn), compiled without most XLA:CPU optimisation passes
    (test_torch_train.jax_fast_compile): the same numbers within these
    tests' tolerances, in a fraction of the compile time."""
    jitted = jax.jit(fn)

    def call(*args):
        with jax_fast_compile():
            return jitted(*args)
    return call


@pytest.fixture
def jax_ties_first(monkeypatch):
    """JAX's min_area_rect with the port's tie rule (test_torch_slice)."""
    monkeypatch.setattr(geo_ref, "min_area_rect",
                        lambda p: jax.vmap(_min_area_rect_first_tie)(
                            p.reshape(p.shape[0], -1)))


def iou_case(seed, b, n, m):
    """(b, n, 8) subjects and (b, m, 8) clip quads at class-offset
    coordinates (up to ~3e4), the columns a shuffled copy of the rows;
    in every image a disjoint subject (row 1) and a degenerate, one-point
    subject (row 2).  (A degenerate clip quad clips nothing, and its IoU is
    area / 1e-8 rounding noise in every formulation.)"""
    rng = np.random.default_rng(seed)
    a = class_offset_quads(rng, b, max(n, m))
    c = a[:, rng.permutation(a.shape[1])]
    a, c = a[:, :n].copy(), c[:, :m].copy()
    a[:, 1] = a[:, 1] + 7e4
    a[:, 2] = np.tile(a[:, 2, :2], 4)
    return a, c


def check_iou(got, ref, atol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    assert (ref > 0.3).sum() >= 10  # the case has real overlaps


@pytest.mark.parametrize("upper_tri", [False, True])
def test_quad_iou_matrix_vs_xla_fallback(upper_tri):
    """The plain tile IoU against the JAX fallback (quad_iou_single, which
    recentres on the subject's mean): f32 rounding, atol 1e-5."""
    a, c = iou_case(0, 1, 90, 70)
    nv = 60 if upper_tri else None
    ref = pallas_quad_iou.quad_iou_matrix_pallas(
        jnp.asarray(a[0]), jnp.asarray(c[0]), upper_tri=upper_tri,
        num_valid=None if nv is None else jnp.int32(nv))
    got = quad_iou.quad_iou_matrix(torch.from_numpy(a[0]),
                                   torch.from_numpy(c[0]), upper_tri, nv)
    check_iou(got, ref, 1e-5)
    assert got[1].max() == 0 and got[2].max() == 0  # disjoint, degenerate


@pytest.mark.parametrize("upper_tri", [False, True])
def test_quad_iou_matrix_batch_vs_xla_fallback(upper_tri):
    a, c = iou_case(1, 2, 64, 64)
    nv = np.array([64, 40], np.int32)
    ref = pallas_quad_iou.quad_iou_matrix_batch_pallas(
        jnp.asarray(a), jnp.asarray(c), upper_tri=upper_tri,
        num_valid=jnp.asarray(nv))
    got = quad_iou.quad_iou_matrix_batch(
        torch.from_numpy(a), torch.from_numpy(c), upper_tri,
        torch.from_numpy(nv))
    check_iou(got, ref, 1e-5)


@pytest.mark.parametrize("batched,upper_tri",
                         [(False, False), (False, True), (True, False),
                          (True, True)])
def test_quad_iou_vs_pallas_interpret(monkeypatch, batched, upper_tri):
    """Same order of operations as the Pallas tile; XLA:CPU may still round
    a product or a sum differently, hence 1e-6 and not equality.  Shapes
    differ from the fallback tests' so that no cached trace is reused."""
    monkeypatch.setenv("ORP_FORCE_PALLAS_INTERPRET", "1")
    a, c = iou_case(2, 2 if batched else 1, 20, 150)
    nv = np.array([17, 9][:a.shape[0]], np.int32)
    if batched:
        ref = pallas_quad_iou.quad_iou_matrix_batch_pallas(
            jnp.asarray(a), jnp.asarray(c), upper_tri=upper_tri,
            num_valid=jnp.asarray(nv))
        got = quad_iou.quad_iou_matrix_batch(
            torch.from_numpy(a), torch.from_numpy(c), upper_tri,
            torch.from_numpy(nv))
    else:
        ref = pallas_quad_iou.quad_iou_matrix_pallas(
            jnp.asarray(a[0]), jnp.asarray(c[0]), upper_tri=upper_tri,
            num_valid=jnp.int32(nv[0]))
        got = quad_iou.quad_iou_matrix(torch.from_numpy(a[0]),
                                       torch.from_numpy(c[0]), upper_tri,
                                       int(nv[0]))
    if upper_tri:
        assert np.asarray(ref)[..., np.tril_indices(20)[0],
                               np.tril_indices(20)[1]].max() == 0
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (ref > 0.3).sum() >= (3 if upper_tri else 20)


@pytest.mark.parametrize("n,m,nv", [(130, 70, None), (130, 130, 0),
                                    (130, 130, 65), (130, 130, 200)])
def test_quad_iou_ragged_tiles_vs_pallas_interpret(monkeypatch, n, m, nv):
    """The plain full (nv None) and tri entries at shapes that cross the
    CUDA kernels' 64 x 64 tiles (N, M not multiples of 64, N != M) and at
    prefixes 0, mid-tile and above N, against Pallas in interpret mode:
    1e-6, as test_quad_iou_vs_pallas_interpret."""
    monkeypatch.setenv("ORP_FORCE_PALLAS_INTERPRET", "1")
    a, c = iou_case(4, 1, n, m)
    if nv is None:
        ref = pallas_quad_iou.quad_iou_matrix_pallas(jnp.asarray(a[0]),
                                                     jnp.asarray(c[0]))
        got = quad_iou.quad_iou_matrix(torch.from_numpy(a[0]),
                                       torch.from_numpy(c[0]))
    else:
        ref = pallas_quad_iou.quad_iou_matrix_batch_pallas(
            jnp.asarray(a), jnp.asarray(c), upper_tri=True,
            num_valid=jnp.asarray([nv], jnp.int32))
        got = quad_iou.quad_iou_matrix_batch(
            torch.from_numpy(a), torch.from_numpy(c), True,
            torch.tensor([nv], dtype=torch.int32))
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape == ((n, m) if nv is None else (1, n, m))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (ref > 0.3).sum() >= (0 if nv == 0 else 20)
    if nv is not None:
        rows, cols = np.indices((n, m))
        dead = (cols <= rows) | (rows >= nv) | (cols >= nv)
        assert (got[0][dead] == 0).all()


def test_over_mask_single_entry_vs_pallas_interpret(monkeypatch):
    """The single-image over-mask is pack_bits(tri IoU > thr) of the same
    pairs; bits may differ from Pallas only at IoU ties with thr."""
    monkeypatch.setenv("ORP_FORCE_PALLAS_INTERPRET", "1")
    q = class_offset_quads(np.random.default_rng(3), 1, 72)[0]
    ref = np.asarray(pallas_quad_iou.quad_over_matrix_pallas(
        jnp.asarray(q), 0.4, num_valid=jnp.int32(65)))
    words = quad_iou.quad_over_matrix(torch.from_numpy(q), 0.4, 65)
    got = quad_iou.unpack_bits(words, 72).numpy()
    tri = quad_iou.quad_iou_matrix(torch.from_numpy(q), torch.from_numpy(q),
                                   True, 65)
    np.testing.assert_array_equal(got, (tri > 0.4).numpy())
    diff = got != ref
    assert got.sum() > 20
    assert np.all(np.abs(tri.numpy()[diff] - 0.4) < 1e-5)


def rboxes(rng, n):
    return np.concatenate([rng.uniform(0, 200, (n, 2)),
                           rng.uniform(5, 60, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


def test_box_iou_rotated_matches():
    rng = np.random.default_rng(4)
    r1, r2 = rboxes(rng, 40), rboxes(rng, 30)
    r2[:10] = r1[:10] + rng.normal(0, 2, (10, 5)).astype(np.float32)
    np.testing.assert_allclose(
        geometry.rbox_to_quad(torch.from_numpy(r1)).numpy(),
        np.asarray(geo_ref.rbox_to_quad(jnp.asarray(r1))), rtol=0,
        atol=1e-4)
    ref = geo_ref.box_iou_rotated(jnp.asarray(r1), jnp.asarray(r2))
    got = geometry.box_iou_rotated(torch.from_numpy(r1), torch.from_numpy(r2))
    check_iou(got, ref, 1e-5)


def nms_case(seed, n=120):
    """Quads with many overlaps (jittered copies of n/6 boxes) and scores,
    a fifth of the rows invalid."""
    rng = np.random.default_rng(seed)
    q = class_offset_quads(rng, 1, n)[0]
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    valid = rng.random(n) > 0.2
    return q, scores, valid


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_rnms_matches(method):
    q, scores, valid = nms_case(5)
    ref_s, ref_k = fast_jit(lambda q_, s_, v_: nms_ref.soft_rnms(
        q_, s_, iou_thr=0.3, method=method, valid=v_, min_score=0.05))(
        q, scores, valid)
    got_s, got_k = nms.soft_rnms(
        torch.from_numpy(q), torch.from_numpy(scores), iou_thr=0.3,
        method=method, valid=torch.from_numpy(valid), min_score=0.05)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-5,
                               atol=0)
    assert 10 < got_k.sum() < valid.sum()  # min_score stops the loop
    assert (got_s.numpy() < scores).sum() > 20  # scores decayed


def test_rotated_nms_mask_matches():
    q, scores, valid = nms_case(6)
    scores[:10] = scores[10:20]  # equal scores: the reversed argsort order
    ref = fast_jit(lambda q_, s_, v_: nms_ref.rotated_nms_mask(
        q_, s_, 0.4, valid=v_))(q, scores, valid)
    got = nms.rotated_nms_mask(torch.from_numpy(q), torch.from_numpy(scores),
                               0.4, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 10 < got.sum() < valid.sum()


def assert_dets_equal(got, ref, reppoints=False):
    """dets, labels, valid equal; polys tie-aware within 1e-3 px (f32
    arithmetic in another order), scores within 1e-6 (sigmoid rounding)."""
    dets, labels, valid = (np.asarray(x) for x in got)
    dets_r, labels_r, valid_r = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(valid, valid_r)
    np.testing.assert_array_equal(labels[valid], labels_r[valid])
    d, r = dets[valid], dets_r[valid]
    p0 = 18 if reppoints else 0
    np.testing.assert_allclose(d[:, p0 + 8], r[:, p0 + 8], rtol=0, atol=1e-6)
    assert np.all(same_min_rect(d[:, p0:p0 + 8], r[:, p0:p0 + 8]))
    return int(valid.sum())


def test_multiclass_rnms_matches():
    rng = np.random.default_rng(7)
    n, c = 80, 5
    boxes = class_offset_quads(rng, 1, n)[0] - 2000.0 * (
        np.arange(n) // 4 % 15)[:, None]
    scores = np.zeros((n, c + 1), np.float32)
    scores[:, 1:] = rng.uniform(0, 1, (n, c)) ** 3
    pts = rng.normal(0, 50, (n, 18)).astype(np.float32)
    kw = dict(score_thr=0.05, iou_thr=0.4, max_per_img=100, pre_nms_cap=200)
    ref = fast_jit(lambda b_, s_, p_: nms_ref.multiclass_rnms(
        b_, s_, reppoints=p_, **kw))(boxes, scores, pts)
    got = nms.multiclass_rnms(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              reppoints=torch.from_numpy(pts), **kw)
    assert got[0].shape == (100, 27)
    assert assert_dets_equal(got, ref, reppoints=True) > 30


def head_outputs(rng, b, canvas, classes=15):
    """Random per-level head outputs (NHWC) of a canvas: logits around the
    score threshold, offsets spread over a few px."""
    outs = {"cls_scores": [], "pts_refine": []}
    for stride in detector.POINT_STRIDES:
        h, w = -(-canvas[0] // stride), -(-canvas[1] // stride)
        outs["cls_scores"].append(
            rng.normal(-3.5, 1.2, (b, h, w, classes)).astype(np.float32))
        outs["pts_refine"].append(
            rng.normal(0, 1.5, (b, h, w, 18)).astype(np.float32))
    return outs


def test_decode_no_nms_and_merge_match(jax_ties_first):
    """Three augs with their own frames (the merge's img_shape), flips and
    scale factors; their head outputs share one size, so that the JAX
    decode compiles once."""
    rng = np.random.default_rng(8)
    augs = [((64, 64), False, 0.5 * 0.8), ((128, 128), True, 1.0 * 0.8),
            ((192, 192), True, 1.5 * 0.8)]
    decode_ref = fast_jit(lambda o: detector_ref.decode_no_nms(o, nms_pre=60))
    boxes, scores, boxes_r, scores_r = [], [], [], []
    for _ in augs:
        outs = head_outputs(rng, 2, (96, 96))
        b, s = detector.decode_no_nms(
            {k: [torch.from_numpy(x) for x in v] for k, v in outs.items()},
            nms_pre=60)
        br, sr = decode_ref(outs)
        # the two sigmoids round differently in the last bit
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=1e-6,
                                   atol=0)
        assert np.all(same_min_rect(b.numpy().reshape(-1, 8),
                                    np.asarray(br).reshape(-1, 8)))
        boxes.append(b)
        scores.append(s)
        boxes_r.append(br)
        scores_r.append(sr)
    kw = dict(score_thr=0.05, iou_thr=0.4, max_per_img=80, pre_nms_cap=300)
    args = ([a[1] for a in augs], [a[0] for a in augs],
            [np.float32(a[2]) for a in augs])
    merge_ref = fast_jit(lambda bl, sl: detector_ref.merge_aug_and_nms(
        bl, sl, *args, **kw))
    total = 0
    for i in range(2):
        got = detector.merge_aug_and_nms([b[i] for b in boxes],
                                         [s[i] for s in scores], *args, **kw)
        ref = merge_ref([b[i] for b in boxes_r], [s[i] for s in scores_r])
        total += assert_dets_equal(got, ref)
    assert total > 40


@pytest.mark.parametrize("size", [(64, 64), (192, 192), (75, 101)])
def test_resize_linear_matches_cv2(size):
    """Float canvases, zero padding on the right and bottom as on a TTA
    canvas: atol 1e-4 (cv2 rounds its taps otherwise)."""
    canvas = np.zeros((2, 128, 128, 3), np.float32)
    canvas[:, :100, :120] = np.random.default_rng(9).normal(
        0, 2, (2, 100, 120, 3))
    got = host.resize_linear(torch.from_numpy(canvas), size).numpy()
    for i in range(2):
        ref = cv2.resize(canvas[i], size[::-1],
                         interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=1e-4)
    assert host.ceil32(128 * 1.5) == 192 and host.ceil32(75) == 96


def test_parse_tta_spec_matches():
    for spec in (("0.5,1.0,1.5", True), ("0.5,1.0", False), (None, True),
                 (None, False)):
        assert apis.parse_tta_spec(*spec) == apis_ref.parse_tta_spec(*spec)


@pytest.fixture(scope="module")
def tiny():
    """A tiny R-18 (widths 32): the JAX model's initial weights, head
    perturbed (test_torch_slice.perturb_head), and the same weights in the
    port; three normalized images (one short batch of the two)."""
    model_ref = OrientedRepPointsDetector(
        depth=18, num_classes=16, fpn_out_channels=WIDTH,
        head_kwargs=dict(feat_channels=WIDTH, point_feat_channels=WIDTH))
    # the weights do not depend on the image size
    variables = fast_jit(model_ref.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    variables = perturb_head(jax.tree_util.tree_map(np.array,
                                                    dict(variables)),
                             np.random.default_rng(0))
    cfg = {"model": dict(
        backbone=dict(type="ResNet", depth=18),
        neck=dict(out_channels=WIDTH, num_outs=5),
        bbox_head=dict(num_classes=16, feat_channels=WIDTH,
                       point_feat_channels=WIDTH))}
    model = build_detector(cfg, "float32")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    rng = np.random.default_rng(10)
    dataset = [dict(img=rng.normal(0, 1, (h, w, 3)).astype(np.float32),
                    scale_factor=sf, img_info=dict(file_name=f"p{i}.png"))
               for i, (h, w, sf) in enumerate(((128, 128, 1.0),
                                               (100, 120, 0.8),
                                               (128, 96, 1.25)))]
    return model_ref, variables, model.eval(), dataset


def tta_reference(model_ref, variables, dataset, augs):
    """The JAX package's TTA, composed of model.apply, decode_no_nms and
    merge_aug_and_nms with run_inference_tta's canvases (its 8-device
    shard_infer is left out)."""
    apply = fast_jit(model_ref.apply)
    decode = fast_jit(lambda o: detector_ref.decode_no_nms(
        o, nms_pre=TC["nms_pre"]))
    scales = list(dict.fromkeys(r for r, _ in augs))
    canvases = {r: (host.ceil32(CANVAS[0] * r), host.ceil32(CANVAS[1] * r))
                for r in scales}
    merge = fast_jit(lambda bl, sl, sfs: detector_ref.merge_aug_and_nms(
        bl, sl, [f for _, f in augs], [canvases[r] for r, _ in augs], sfs,
        score_thr=TC["score_thr"], iou_thr=TC["nms"]["iou_thr"],
        max_per_img=TC["max_per_img"], pre_nms_cap=TC["pre_nms_cap"]))
    results = {}
    for lo in range(0, len(dataset), 2):
        items = dataset[lo:lo + 2]
        base = np.zeros((2,) + CANVAS + (3,), np.float32)
        for bi, s in enumerate(items):
            base[bi, :s["img"].shape[0], :s["img"].shape[1]] = s["img"]
        per_aug = {}
        for r in scales:
            x = np.zeros((2,) + canvases[r] + (3,), np.float32)
            rh, rw = int(round(CANVAS[0] * r)), int(round(CANVAS[1] * r))
            for bi in range(2):
                x[bi, :rh, :rw] = (base[bi] if r == 1.0 else cv2.resize(
                    base[bi], (rw, rh), interpolation=cv2.INTER_LINEAR))
            for ai, (rr, flip) in enumerate(augs):
                if rr == r:
                    per_aug[ai] = decode(apply(
                        variables, jnp.asarray(x[:, :, ::-1] if flip else x)))
        for bi, s in enumerate(items):
            dets, labels, valid = merge(
                [per_aug[a][0][bi] for a in range(len(augs))],
                [per_aug[a][1][bi] for a in range(len(augs))],
                [np.float32(s["scale_factor"] * r) for r, _ in augs])
            keep = np.asarray(valid)
            name = s["img_info"]["file_name"][:-4]
            results[name] = (np.asarray(dets)[keep], np.asarray(labels)[keep])
    return results


def test_run_inference_tta_matches_jax(tiny, jax_ties_first):
    """Each framework runs its own model on its own resized canvases: head
    outputs differ at f32 rounding (2e-4 relative, offsets scaled by
    strides up to 128 px) and the resizes by up to ~3e-5, hence the
    predictor test's tolerances: scores 1e-4, polys 0.05 px."""
    model_ref, variables, model, dataset = tiny
    ref = tta_reference(model_ref, variables, dataset, AUGS)
    got = apis.run_inference_tta(model, dataset, TC, AUGS, canvas=CANVAS,
                                 batch_size=2)
    assert set(got) == set(ref) == {"p0", "p1", "p2"}
    total = 0
    for name, (dets_r, labels_r) in ref.items():
        assert len(got[name]) == 15
        for ci, a in enumerate(got[name]):
            b = dets_r[labels_r == ci]
            assert a.shape == b.shape, (name, ci)
            # dets whose scores differ by rounding may swap places
            free = np.ones(len(b), bool)
            for row in a:
                hit = free & (np.abs(b[:, 8] - row[8]) <= 1e-4) & \
                    same_min_rect(np.tile(row[:8], (len(b), 1)), b[:, :8],
                                  tol=0.05)
                assert hit.any(), (name, ci, row)
                free[np.argmax(hit)] = False
            total += len(a)
    assert total > 60


def test_identity_aug_equals_run_inference(tiny):
    """run_inference_tta([(1.0, False)]) is run_inference det for det
    (tests/test_tta_identity.py's guarantee), exactly."""
    _, _, model, dataset = tiny
    plain = apis.run_inference(model, dataset, TC, canvas=CANVAS,
                               batch_size=2)
    tta = apis.run_inference_tta(model, dataset, TC, [(1.0, False)],
                                 canvas=CANVAS, batch_size=2)
    assert set(plain) == set(tta) == {"p0", "p1", "p2"}
    total = 0
    for name in plain:
        for a, b in zip(plain[name], tta[name]):
            np.testing.assert_array_equal(a, b)
            total += len(a)
    assert total > 60
