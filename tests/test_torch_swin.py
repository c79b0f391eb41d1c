"""The PyTorch port's Swin path against the JAX package's, on the CPU.

A Swin with narrow widths (embed 32, depths (2, 2, 2, 2), so that every
stage has a shifted block; heads (1, 2, 4, 8)): the window helpers, the
backbone (at 224^2, where stage 3's window covers the whole map, and at
100^2, the pad path), the detector through the max-pool FPN at 224^2 and
run_inference det for det, the official-Swin converter with its
bias-table resize, AdamW (the no-decay set exactly, three steps of
build_trainer's recipe against the JAX step) and DropPath (its masks,
their seeding and a resumed run bit for bit).  Weights: the flax tree
(norm affines and biases perturbed) through flax_to_torch.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.core.loss_head import LossConfig as LossConfigRef
from orientedreppoints_tpu.core.rbox import rbbox2result as rbbox2result_ref
from orientedreppoints_tpu.models import OrientedRepPointsDetector
from orientedreppoints_tpu.models import decode_detections as decode_ref
from orientedreppoints_tpu.models import swin as swin_ref
from orientedreppoints_tpu.parallel import train as train_ref
from orientedreppoints_tpu.utils import checkpoint as ckpt_ref
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.models import swin
from orientedreppoints_tpu_torch.parallel import train
from orientedreppoints_tpu_torch.utils import checkpoint
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_converters import synth_swin_tiny_sd
from test_torch_models import numpy_tree, perturb_norms
from test_torch_slice import jax_ties_first, perturb_head  # noqa: F401
from test_torch_slice import same_min_rect
from test_torch_train import jax_fast_compile, make_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_SWIN = os.path.join(REPO, "configs/dota/synth_swin_512.py")
SWIN_KW = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
WIDTH = 32
IMG = 128  # test_torch_train.make_batch's canvas
DET = 224
TC = dict(nms_pre=100, score_thr=0.05, nms=dict(iou_thr=0.4),
          max_per_img=60, pre_nms_cap=256)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def fast_jit(fn):
    jitted = jax.jit(fn)

    def call(*args):
        with jax_fast_compile():
            return jitted(*args)
    return call


def tiny_cfg(drop_path_rate=0.0):
    """configs/dota/synth_swin_512.py (AdamW, lr 1e-4, wd 0.05, warmup
    100) at the narrow widths, 128^2 canvas, max_pos 64."""
    cfg = load_config(SYNTH_SWIN)
    cfg["model"]["backbone"].update(
        embed_dim=32, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8],
        drop_path_rate=drop_path_rate)
    cfg["model"]["neck"]["out_channels"] = WIDTH
    cfg["model"]["bbox_head"].update(in_channels=WIDTH, feat_channels=WIDTH,
                                     point_feat_channels=WIDTH)
    cfg["tpu"].update(max_pos=64, canvas_buckets=[(IMG, IMG)])
    return cfg


def jax_detector(dtype=jnp.float32, drop_path_rate=0.0):
    return OrientedRepPointsDetector(
        backbone_type="swin", num_classes=16, fpn_out_channels=WIDTH,
        dtype=dtype, backbone_kwargs=dict(SWIN_KW,
                                          drop_path_rate=drop_path_rate),
        head_kwargs=dict(feat_channels=WIDTH, point_feat_channels=WIDTH))


def port_detector(variables, cfg=None):
    model = apis.build_detector(cfg or tiny_cfg(), "float32")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model.eval()


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def test_window_partition_and_reverse_match():
    x = np.random.default_rng(0).normal(size=(2, 14, 28, 8)).astype(
        np.float32)
    want = np.asarray(swin_ref.window_partition(jnp.asarray(x), 7))
    got = swin.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(got.numpy(), want)
    back = swin.window_reverse(got, 7, 14, 28)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        swin_ref.window_reverse(jnp.asarray(want), 7, 14, 28)))


@pytest.mark.parametrize("ws", [2, 7, 12])
def test_relative_position_index_matches(ws):
    np.testing.assert_array_equal(swin.relative_position_index(ws),
                                  swin_ref._relative_position_index(ws))


@pytest.mark.parametrize("hp, wp", [(7, 7), (14, 28), (133, 133)])
def test_shift_attn_mask_matches(hp, wp):
    want = swin_ref._shift_attn_mask(hp, wp, 7, 3)
    got = swin.shift_attn_mask(hp, wp, 7, 3)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# backbone
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [224, 100], ids=["window_covers_map",
                                                  "pad"])
def test_backbone_matches(size, dtype):
    """Each emitted stage against the flax module on the same weights.
    f32: within 1e-5 of the output's largest element (measured ~1e-6: f32
    sums in another order).  bf16: within 2.5e-2 of it, three roundings
    at the largest element's exponent (measured ~1e-2): the two frameworks
    round the Dense and GELU results at different places."""
    jdt, tdt = DTYPES[dtype]
    ref = swin_ref.SwinTransformer(dtype=jdt, **SWIN_KW)
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(
        np.float32)
    variables = perturb_norms(numpy_tree(fast_jit(ref.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))), np.random.RandomState(0))
    outs_ref = jax.jit(ref.apply)(variables, x)
    model = swin.SwinTransformer(**SWIN_KW)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        outs = model.eval()(torch.from_numpy(x).to(tdt))
    assert len(outs) == 3
    tol = 1e-5 if dtype == "float32" else 2.5e-2
    for got, want in zip(outs, outs_ref):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == tdt
        assert got.is_contiguous(memory_format=torch.channels_last)
        got = got.permute(0, 2, 3, 1).float().numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= tol * np.abs(want).max(), err


def test_backbone_init_is_flax_init():
    """Truncated normal of std 0.02 at +-2 sigma / 0.8796 (flax's
    truncated_normal), zero Dense biases, LayerNorm ones and zeros."""
    model = swin.SwinTransformer(embed_dim=96, depths=(2, 2, 6, 2),
                                 num_heads=(3, 6, 12, 24))
    model.init_weights(torch.Generator().manual_seed(0))
    w = torch.cat([m.weight.flatten() for m in model.modules()
                   if isinstance(m, swin.Linear)])
    assert abs(float(w.detach().std()) - 0.02) < 2e-4
    assert float(w.detach().abs().max()) <= 2 * 0.02 / 0.87962566 + 1e-7
    for name, p in model.named_parameters():
        if "norm" in name:
            want = 1.0 if name.endswith("weight") else 0.0
            assert bool((p == want).all()), name
        elif name.endswith("bias"):
            assert bool((p == 0).all()), name
    # no state buffers: the relative index is a non-persistent constant
    assert all(name.endswith("rel_index")
               for name, _ in model.named_buffers())
    assert not any(k.endswith("rel_index") for k in model.state_dict())


@pytest.mark.parametrize("config", ["orientedreppoints_swin_tiny_demo.py",
                                    "synth_swin_512.py"])
def test_swin_tree_converts_and_loads_strictly(config):
    """Every leaf of the JAX builder's Swin-T detector (published widths)
    maps to one port tensor, and the port's detector takes them all."""
    from orientedreppoints_tpu.utils import Config, builder

    path = os.path.join(REPO, "configs/dota", config)
    shapes = jax.eval_shape(builder.build_detector(Config.fromfile(path),
                                                   "float32").init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))
    sd = flax_to_torch(tree)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree))
    model = apis.build_detector(load_config(path), "float32")
    model.load_state_dict(sd, strict=True)
    assert len(model.state_dict()) == len(sd)
    assert model.neck.start_level == 0 and not model.neck.add_extra_convs


# --------------------------------------------------------------------------
# detector: the max-pool FPN and run_inference
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def det():
    model_ref = jax_detector()
    x = np.random.default_rng(2).normal(size=(2, DET, DET, 3)).astype(
        np.float32)
    variables = numpy_tree(fast_jit(model_ref.init)(jax.random.PRNGKey(0),
                                                    jnp.asarray(x)))
    perturb_norms(variables["params"]["backbone"], np.random.RandomState(1))
    # point convs x30: the point sets spread over about a stride
    variables = perturb_head(variables, np.random.default_rng(0),
                             pts_scale=30.0)
    apply = fast_jit(model_ref.apply)
    return dict(model_ref=model_ref, variables=variables, apply=apply, x=x,
                outs_ref=apply(variables, jnp.asarray(x)),
                model=port_detector(variables))


@pytest.mark.parametrize("c3_hw", [(28, 28), (25, 63)], ids=["even", "odd"])
def test_max_pool_fpn_matches(c3_hw):
    """The FPN at start_level 0 with max-pool extra levels (window 1,
    stride 2, VALID: ceil(H / 2)) against the flax module on odd sizes,
    f32 within 1e-4 of max(1, the largest element) (test_torch_models'
    FPN tolerance); no extra conv is created."""
    from orientedreppoints_tpu.models.fpn import FPN as FPNRef
    from orientedreppoints_tpu_torch.models.fpn import FPN

    rng = np.random.default_rng(7)
    h, w = c3_hw
    chans = (64, 128, 256)
    feats = [rng.normal(size=(2, -(-h // 2 ** i), -(-w // 2 ** i), c))
             .astype(np.float32) for i, c in enumerate(chans)]
    ref = FPNRef(out_channels=32, num_outs=5, start_level=0,
                 add_extra_convs=False)
    variables = perturb_norms(numpy_tree(ref.init(jax.random.PRNGKey(0),
                                                  feats)),
                              np.random.RandomState(0))
    outs_ref = ref.apply(variables, feats)
    fpn = FPN(list(chans), 32, 5, start_level=0, add_extra_convs=False)
    assert not any("extra" in k for k in fpn.state_dict())
    fpn.load_state_dict(flax_to_torch(variables), strict=True)
    with torch.no_grad():
        outs = fpn.eval()([torch.from_numpy(np.ascontiguousarray(
            f.transpose(0, 3, 1, 2))) for f in feats])
    assert len(outs) == 5
    for got, want in zip(outs, outs_ref):
        want = np.asarray(want)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4 * max(1.0,
                                                       np.abs(want).max())


@pytest.mark.parametrize("key", ["base_feats", "cls_scores", "pts_init",
                                 "pts_refine"])
def test_detector_levels_match(det, key):
    """The five levels through the max-pool FPN (start_level 0): 28, 14,
    7, 4, 2 at 224^2, and the head on them; f32, within 2e-4 of each
    output's largest element (test_torch_slice's tolerance: two conv
    libraries' sums, grown through GN; measured 1.6e-4 on pts_refine)."""
    with torch.no_grad():
        outs = det["model"](torch.from_numpy(det["x"]))
    assert len(outs[key]) == len(det["outs_ref"][key]) == 5
    for lvl, (got, want) in enumerate(zip(outs[key],
                                          det["outs_ref"][key])):
        want = np.asarray(want)
        hw = -(-DET // (8 * 2 ** lvl))
        assert want.shape[1:3] == (hw, hw)
        got = got.numpy() if got.shape == want.shape else \
            got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= 2e-4 * max(1.0, np.abs(want).max()), (lvl, err)


def test_run_inference_matches_jax(det, jax_ties_first):  # noqa: F811
    """apis.run_inference with the Swin detector against the JAX model's
    apply + decode_detections with run_inference's batching (its own
    run_inference shards over 8 devices, slow here): scores within 1e-4,
    polygons within 0.05 px up to corner order, dets of rounding-close
    scores matched one to one (test_torch_eval_path's tolerances)."""
    rng = np.random.default_rng(3)
    sizes = ((224, 224), (200, 150), (96, 224))
    ds = [dict(img=rng.normal(size=hw + (3,)).astype(np.float32),
               scale_factor=sf, img_info=dict(file_name=f"im{i}.npy"))
          for i, (hw, sf) in enumerate(zip(sizes, (1.0, 0.75, 1.5)))]
    got = apis.run_inference(det["model"], ds, TC, canvas=(DET, DET),
                             batch_size=2)
    decode = fast_jit(lambda o, sf: decode_ref(
        o, nms_pre=TC["nms_pre"], score_thr=TC["score_thr"],
        iou_thr=TC["nms"]["iou_thr"], max_per_img=TC["max_per_img"],
        pre_nms_cap=TC["pre_nms_cap"], scale_factor=sf))
    ref = {}
    for lo in (0, 2):
        items = ds[lo:lo + 2]
        x = np.zeros((2, DET, DET, 3), np.float32)
        sfs = np.ones((2, 1, 1), np.float32)
        for bi, s in enumerate(items):
            x[bi, :s["img"].shape[0], :s["img"].shape[1]] = s["img"]
            sfs[bi] = s["scale_factor"]
        dets, labels, valid = map(np.asarray, decode(
            det["apply"](det["variables"], jnp.asarray(x)),
            jnp.asarray(sfs)))
        for bi, s in enumerate(items):
            ref[s["img_info"]["file_name"][:-4]] = rbbox2result_ref(
                dets[bi][valid[bi]][:, -9:], labels[bi][valid[bi]], 16)
    assert set(got) == set(ref) == {"im0", "im1", "im2"}
    total = 0
    for name, per_class in ref.items():
        assert len(got[name]) == len(per_class) == 15
        for ci, (a, b) in enumerate(zip(got[name], per_class)):
            assert a.shape == b.shape, (name, ci)
            free = np.ones(len(b), bool)
            for row in a:
                hit = free & (np.abs(b[:, 8] - row[8]) <= 1e-4) & \
                    same_min_rect(np.tile(row[:8], (len(b), 1)), b[:, :8],
                                  tol=0.05)
                assert hit.any(), (name, ci, row)
                free[np.argmax(hit)] = False
            total += len(a)
    assert total > 60


# --------------------------------------------------------------------------
# the official-Swin converter
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nh", [4, 6])
def test_bias_table_resize_matches_jax(nh):
    """13^2 -> 23^2 against the JAX package's cv2 resize.  cv2 hands 1-,
    3- and 4-channel float resizes to IPP, which rounds its weights
    otherwise (within 2e-6 of the table's largest element: measured
    8.3e-7); other channel counts take OpenCV's own loops, which the
    numpy rebuild follows bit for bit."""
    table = np.random.default_rng(nh).normal(size=(13 * 13, nh)).astype(
        np.float32)
    want = ckpt_ref._interp_bias_table(table, 23 * 23)
    got = checkpoint.interp_bias_table(table, 23 * 23)
    assert got.shape == want.shape == (23 * 23, nh)
    assert got.dtype == np.float32
    if nh == 6:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    np.testing.assert_array_equal(checkpoint.interp_bias_table(table,
                                                               13 * 13),
                                  table)


@pytest.mark.parametrize("s1, s2, nh", [(13, 23, 3), (13, 23, 4),
                                        (23, 13, 1), (5, 13, 24)])
def test_bias_table_resize_is_opencvs_bicubic(s1, s2, nh):
    """Without IPP, cv2's INTER_CUBIC of a float32 grid bit for bit:
    A = -0.75, half-pixel source coordinates, taps clamped at the border,
    the horizontal pass summed in order, the vertical one in 4-lane
    vectors from the last tap (scalar tail in order)."""
    grid = np.random.default_rng(s1 + nh).normal(size=(s1, s1, nh)).astype(
        np.float32)
    use_ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        want = cv2.resize(grid, (s2, s2), interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(use_ipp)
    got = checkpoint.interp_bias_table(grid.reshape(-1, nh), s2 * s2)
    np.testing.assert_array_equal(got, want.reshape(s2 * s2, nh))


@pytest.fixture(scope="module")
def official_sd():
    return synth_swin_tiny_sd(np.random.RandomState(0))


@pytest.mark.parametrize("window", [7, 12], ids=["same", "resized"])
def test_convert_swin_tiny_matches_jax(official_sd, window):
    """The port's state dict equals the JAX tree through flax_to_torch:
    every name, and every value (the resized bias tables of stage 0's 3
    heads within IPP's rounding, see above)."""
    got = checkpoint.convert_swin_tiny(official_sd, window_size=window)
    want = flax_to_torch({"params": ckpt_ref.convert_swin_tiny(
        official_sd, window_size=window)})
    assert set(got) == set(want)
    for k, v in want.items():
        if window != 7 and k.endswith("bias_table") and v.shape[1] == 3:
            assert float((got[k] - v).abs().max()) <= 2e-6 * float(
                v.abs().max()), k
        else:
            assert torch.equal(got[k], v), k


def test_converted_swin_tiny_forward_matches_jax(official_sd):
    """Loaded strictly into the port's Swin-T (published widths), the
    forward equals JAX's on the converted tree within 1e-5 of each
    output's largest element (f32)."""
    sd = checkpoint.convert_swin_tiny(official_sd)
    model = swin.SwinTransformer()
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(4).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    ref = swin_ref.SwinTransformer()
    outs_ref = jax.jit(ref.apply)(
        {"params": ckpt_ref.convert_swin_tiny(official_sd)}, x)
    with torch.no_grad():
        outs = model.eval()(torch.from_numpy(x))
    for got, want in zip(outs, outs_ref):
        want = np.asarray(want)
        got = got.permute(0, 2, 3, 1).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_load_pretrained_swin_unwraps(official_sd, tmp_path):
    """A `model` wrapper with `backbone.` prefixes, loaded into a Swin-T
    detector: the backbone equals the converted dict, nothing is left
    missing; a classification checkpoint (one final `norm`) leaves the
    first two out-norms as they were."""
    model = apis.build_detector(load_config(SYNTH_SWIN), "float32")
    path = str(tmp_path / "swin.pth")
    torch.save({"model": {"backbone." + k: torch.from_numpy(v)
                          for k, v in official_sd.items()}}, path)
    assert checkpoint.load_pretrained_swin(model, path) == []
    want = checkpoint.convert_swin_tiny(official_sd)
    got = model.backbone.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    cls_sd = {k: v for k, v in official_sd.items()
              if not k.startswith("norm")}
    cls_sd["norm.weight"] = official_sd["norm3.weight"] * 2
    cls_sd["norm.bias"] = official_sd["norm3.bias"]
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in cls_sd.items()}}, path)
    missing = checkpoint.load_pretrained_swin(model, path)
    assert sorted(missing) == [f"out_norm{s}.{leaf}" for s in (1, 2)
                               for leaf in ("bias", "weight")]
    assert torch.equal(model.backbone.out_norm3.weight,
                       torch.from_numpy(cls_sd["norm.weight"]))


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_setup():
    model_ref = jax_detector()
    variables = jax.jit(model_ref.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    variables = perturb_head(numpy_tree(variables), np.random.default_rng(0))
    cfg = tiny_cfg()
    return dict(model_ref=model_ref, variables=variables, cfg=cfg,
                img_norm=apis.build_img_norm(cfg),
                batch=make_batch(np.random.RandomState(0)))


def jax_adamw(params, cfg, iters_per_epoch=10):
    opt, lr = cfg["optimizer"], cfg["lr_config"]
    return train_ref.build_optimizer(
        params, train_ref.lr_schedule(
            base_lr=opt["lr"], warmup_iters=lr["warmup_iters"],
            warmup_ratio=lr["warmup_ratio"], step_epochs=lr["step"],
            iters_per_epoch=iters_per_epoch),
        optimizer="adamw", weight_decay=opt["weight_decay"],
        frozen_prefixes=train_ref.default_frozen_prefixes(
            cfg["model"]["backbone"].get("frozen_stages", 1)))


def test_adamw_no_decay_set_matches_jax(train_setup):
    """JAX's decay_mask, read off its AdamW chain (zero grads on unit
    params: only the masked decay moves a parameter), mapped through
    flax_to_torch's names, equals the port's decay group exactly; the
    bias tables, LayerNorms, GN affines and every bias are out."""
    params = jax.tree_util.tree_map(jnp.ones_like,
                                    train_setup["variables"]["params"])
    tx = jax_adamw(params, train_setup["cfg"])
    updates, _ = fast_jit(tx.update)(
        jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params),
        params)
    moved = flax_to_torch({"params": jax.tree_util.tree_map(
        lambda u: np.asarray(u != 0, np.float32), updates)})
    want = {k for k, v in moved.items() if bool(v.all())}
    assert all(bool(v.all()) or not bool(v.any()) for v in moved.values())
    model = port_detector(train_setup["variables"], train_setup["cfg"])
    optimizer, _, _ = apis.build_trainer(model, train_setup["cfg"])
    ids = {id(p): k for k, p in model.named_parameters()}
    groups = [{ids[id(p)] for p in g["params"]}
              for g in optimizer.param_groups]
    assert isinstance(optimizer, torch.optim.AdamW)
    assert [g["weight_decay"] for g in optimizer.param_groups] == [0.05, 0.0]
    assert groups[0] == want
    assert groups[0] | groups[1] == set(moved)
    assert not groups[0] & groups[1]
    for k in ("backbone.stage0_block1.attn.relative_position_bias_table",
              "backbone.out_norm1.weight", "backbone.patch_norm.bias",
              "neck.fpn_0.gn.weight", "bbox_head.cls_out.bias"):
        assert k in groups[1], k
    assert "backbone.stage0_block1.attn.qkv.weight" in groups[0]


@pytest.mark.parametrize("frozen_stages", [1, -1])
def test_swin_freezes_nothing(train_setup, frozen_stages):
    """ResNet's frozen_stages prefixes (stem, layer{s}_) name nothing in
    Swin: the JAX mask is all False and the port leaves every parameter
    trainable."""
    mask = train_ref._frozen_mask(train_setup["variables"]["params"],
                                  train_ref.default_frozen_prefixes(
                                      frozen_stages))
    assert not any(jax.tree_util.tree_leaves(mask))
    cfg = tiny_cfg()
    cfg["model"]["backbone"]["frozen_stages"] = frozen_stages
    model = port_detector(train_setup["variables"], cfg)
    optimizer, _, _ = apis.build_trainer(model, cfg)
    assert all(p.requires_grad for p in model.parameters())
    assert sum(len(g["params"]) for g in optimizer.param_groups) == \
        len(list(model.parameters()))


def test_adamw_arithmetic_matches_optax():
    """The same grads through the port's clip + AdamW and through the JAX
    chain (clip 35, scale_by_adam, masked decay, LR), three steps, one
    step clipped: parameters within 1e-5 of each update's largest element
    plus two roundings of the parameter a step (f32: torch decays the parameter
    and adds the Adam step in two roundings, optax adds one sum, and the
    bias corrections are applied in another order; measured 2e-6 of an
    update).  A missing bias correction or decay term is off by >1e-3."""
    rng = np.random.default_rng(5)
    shapes = {"w": (4, 3), "norm": (3,), "bias": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (1.0, 30.0, 0.01)]
    sched = train_ref.lr_schedule(base_lr=1e-2, warmup_iters=2,
                                  step_epochs=(1,), iters_per_epoch=2)
    tx = train_ref.build_optimizer(params, sched, optimizer="adamw",
                                   weight_decay=0.05)
    state, p_ref = tx.init(params), jax.tree_util.tree_map(jnp.asarray,
                                                           params)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(
            v.copy())))
    opt, scheduler = train.build_optimizer(
        module, train.lr_schedule(base_lr=1e-2, warmup_iters=2,
                                  step_epochs=(1,), iters_per_epoch=2),
        optimizer="adamw", weight_decay=0.05)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, p_ref)
        p_ref = jax.tree_util.tree_map(lambda p, u: p + u, p_ref, upd)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        train.clip_by_global_norm_([p.grad for p in module.parameters()],
                                   35.0)
        opt.step()
        scheduler.step()
        for k, p in module.named_parameters():
            want = np.asarray(p_ref[k])
            err = np.abs(p.detach().numpy() - want)
            tol = 1e-5 * np.abs(want - params[k]).max() + 2 * (
                scheduler.last_epoch) * np.spacing(np.abs(want))
            assert (err <= tol).all(), k


@pytest.fixture(scope="module")
def three_steps(train_setup):
    """Three steps from the same weights on the same batch: the JAX train
    step with the AdamW chain (DropPath 0) and build_trainer's step."""
    s = train_setup
    tx = jax_adamw(s["variables"]["params"], s["cfg"])
    step_fn = train_ref.make_train_step(
        s["model_ref"], LossConfigRef(max_pos=64), img_norm=s["img_norm"],
        dropout_rng=jax.random.key(0))
    params = jax.tree_util.tree_map(jnp.array, s["variables"]["params"])
    state = train_ref.TrainState(step=jnp.zeros((), jnp.int32),
                                 params=params, batch_stats={},
                                 opt_state=tx.init(params), tx=tx)
    batch = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    ref = []
    for _ in range(3):
        with jax_fast_compile():
            state, losses = step_fn(state, batch)
        ref.append(({k: float(v) for k, v in losses.items()},
                    flax_to_torch({"params": jax.tree_util.tree_map(
                        np.asarray, state.params)})))
    model = port_detector(s["variables"], s["cfg"])
    _, _, step = apis.build_trainer(model, s["cfg"], iters_per_epoch=10)
    got = []
    for _ in range(3):
        losses = step(s["batch"])
        got.append(({k: float(v) for k, v in losses.items()},
                    {k: v.detach().clone()
                     for k, v in model.state_dict().items()},
                    {k: float(p.grad.abs().max())
                     for k, p in model.named_parameters()}))
    return ref, got


@pytest.mark.parametrize("i", [0, 1, 2])
def test_adamw_steps_match_jax(train_setup, three_steps, i):
    """Losses within rel 1e-4 of JAX's.  Updates (new - initial): Adam
    divides each grad by its own running magnitude, so a grad at the
    frameworks' rounding noise steps at full size in either direction.
    The out-norms' biases have such grads here: with one channel a GN
    group (width 32), the lateral conv's GN removes any constant of a
    channel, so their grads are 0 up to rounding (~1e-9).  So each tensor
    whose grad in this step reaches 1e-6 of the model's largest is held
    to 0.1 of its update's norm (measured 0.049, a LayerNorm bias), and
    the whole update, as one vector, to 2e-2 of its norm (measured
    7.1e-3 at the first step)."""
    (ref_losses, ref_sd), (losses, sd, gmax) = (three_steps[0][i],
                                                three_steps[1][i])
    assert ref_losses["num_pos"] > 0
    for k, v in ref_losses.items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    sd0 = flax_to_torch(train_setup["variables"])
    floor = 1e-6 * max(gmax.values())
    diff2 = norm2 = 0.0
    held = 0
    for k, want in ref_sd.items():
        moved, moved_ref = sd[k] - sd0[k], want - sd0[k]
        assert bool((moved_ref != 0).any()), k  # every tensor trains
        d, n = float((moved - moved_ref).norm()), float(moved_ref.norm())
        if gmax[k] >= floor:
            assert d <= 0.1 * n, (k, d / n)
            held += 1
        diff2, norm2 = diff2 + d * d, norm2 + n * n
    assert held >= len(ref_sd) - 6
    assert diff2 ** 0.5 <= 2e-2 * norm2 ** 0.5, (diff2 / norm2) ** 0.5


# --------------------------------------------------------------------------
# DropPath
# --------------------------------------------------------------------------


def test_drop_path_masks():
    """One keep mask per sample, (B, 1, 1, 1), values 0 or 1 / keep; none
    without a mask or at rate 0."""
    y = torch.ones(64, 3, 5, 2)
    mask = torch.from_numpy(np.random.default_rng(0).uniform(size=64) < 0.75)
    out = swin.drop_path(y, 0.25, mask)
    per_sample = out.reshape(64, -1)
    assert bool((per_sample == per_sample[:, :1]).all())
    vals = set(per_sample[:, 0].tolist())
    assert vals == {0.0, float(np.float32(1 / 0.75))}
    assert torch.equal(per_sample[:, 0] != 0, mask)
    assert torch.equal(swin.drop_path(y, 0.25, None), y)
    assert torch.equal(swin.drop_path(y, 0.0, mask), y)


def test_drop_path_train_and_eval():
    """Eval mode draws nothing (a key changes nothing); train mode
    without a key raises; the same (seed, step) gives the same masks,
    another step or seed other ones."""
    model = swin.SwinTransformer(drop_path_rate=0.9, **SWIN_KW)
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 64, 64, 3)).astype(np.float32))

    def run(gen=None):
        with torch.no_grad():
            return torch.cat([o.flatten() for o in model(x, gen)])

    model.eval()
    base = run()
    assert torch.equal(run(train.dropout_key(0, 3)), base)
    model.train()
    with pytest.raises(ValueError, match="key"):
        run()
    a = run(train.dropout_key(0, 3))
    assert torch.equal(a, run(train.dropout_key(0, 3)))
    assert not torch.equal(a, base)
    assert not torch.equal(a, run(train.dropout_key(0, 4)))
    assert not torch.equal(a, run(train.dropout_key(1, 3)))


def cpu_trainer(cfg, seed=0):
    model, _ = apis.init_detector(cfg, compute_dtype="float32",
                                  device="cpu", seed=0)
    optimizer, scheduler, step = apis.build_trainer(model, cfg,
                                                    iters_per_epoch=10,
                                                    seed=seed)
    return model, optimizer, scheduler, step


def test_train_step_fires_drop_path_and_keeps_eval_mode():
    """The step trains with DropPath (another seed, other losses; at rate
    0 the seed changes nothing) and hands the model back in eval mode."""
    batch = make_batch(np.random.RandomState(0))
    totals = {}
    for rate in (0.5, 0.0):
        for seed in (0, 1):
            model, _, _, step = cpu_trainer(tiny_cfg(rate), seed)
            totals[rate, seed] = float(step(batch)["loss_total"])
            assert not model.training
    assert totals[0.5, 0] != totals[0.5, 1]
    assert totals[0.0, 0] == totals[0.0, 1]


def test_resumed_adamw_run_with_drop_path_is_bit_for_bit(tmp_path):
    """AdamW and DropPath 0.5 on the CPU: two steps, a checkpoint, a
    third step (A); fresh objects restored from the checkpoint, the third
    step (B): the AdamW state (exp_avg, exp_avg_sq, step) round-trips and
    B equals A bit for bit."""
    cfg = tiny_cfg(0.5)
    batches = [make_batch(np.random.RandomState(i)) for i in range(3)]
    model, optimizer, scheduler, step = cpu_trainer(cfg)
    for b in batches[:2]:
        step(b)
    path = checkpoint.save_checkpoint(str(tmp_path), 1, model, optimizer,
                                      scheduler, 2)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    adam = [{k: v.clone() for k, v in optimizer.state[p].items()}
            for g in optimizer.param_groups for p in g["params"]]
    losses_a = step(batches[2])
    state_a = model.state_dict()

    model, optimizer, scheduler, step = cpu_trainer(cfg)
    assert checkpoint.load_checkpoint(path, model, optimizer,
                                      scheduler)[0] == 2
    assert all(torch.equal(model.state_dict()[k], v)
               for k, v in saved.items())
    restored = [optimizer.state[p] for g in optimizer.param_groups
                for p in g["params"]]
    assert len(restored) == len(adam) > 0
    for want, got in zip(adam, restored):
        assert set(want) == set(got) == {"step", "exp_avg", "exp_avg_sq"}
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert scheduler.last_epoch == 2
    losses_b = step(batches[2])
    assert all(torch.equal(losses_a[k], losses_b[k]) for k in losses_a)
    assert all(torch.equal(state_a[k], v)
               for k, v in model.state_dict().items())
