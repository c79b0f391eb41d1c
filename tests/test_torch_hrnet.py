"""The PyTorch port's HRNet path against the JAX package's, on the CPU,
and the frozen set of every backbone type.

HRNet on tests/test_backbones.py's TINY_EXTRA (widths 8-64, one block a
branch): the backbone at 64^2 and 96^2 (its stride-32 branch 3 x 3) in
f32 and bf16; the full W32 tree of the demo config, converted and loaded
strictly; the detector (FPN and head widths 32) at 128^2, its levels and
run_inference det for det; one SGD step of build_trainer's recipe against
the JAX step.  Weights: the flax tree (frozen-BN statistics and affines
perturbed, the head's point convs scaled so that point sets spread)
through flax_to_torch.  The helpers here serve tests/test_torch_ssd_vgg.py
too.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.core.loss_head import LossConfig as LossConfigRef
from orientedreppoints_tpu.core.rbox import rbbox2result as rbbox2result_ref
from orientedreppoints_tpu.models import decode_detections as decode_ref
from orientedreppoints_tpu.models.hrnet import HRNet as HRNetRef
from orientedreppoints_tpu.parallel import train as train_ref
from orientedreppoints_tpu.utils import Config, builder
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.models.hrnet import HRNet
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_backbones import TINY_EXTRA
from test_torch_models import nchw, numpy_tree, perturb_norms
from test_torch_slice import jax_ties_first, perturb_head  # noqa: F401
from test_torch_slice import same_min_rect
from test_torch_train import IMG, jax_fast_compile, make_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 32
TC = dict(nms_pre=100, score_thr=0.05, nms=dict(iou_thr=0.4),
          max_per_img=60, pre_nms_cap=256)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bf16: one rounding of the largest element (2^-8).  Both packages round
# each conv's output, the folded BN, the residual adds and the fusion sums
# to bf16 at the same points, and the maps came out equal (measured 0 at
# 64^2 and 96^2)
BF16_RTOL = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def fast_jit(fn):
    jitted = jax.jit(fn)

    def call(*args):
        with jax_fast_compile():
            return jitted(*args)
    return call


def narrow_cfg(config, **backbone):
    """configs/dota/<config> with the backbone's keys updated, FPN and head
    widths WIDTH, max_pos 64 and an IMG^2 canvas."""
    cfg = load_config(os.path.join(REPO, "configs/dota", config))
    cfg["model"]["backbone"].update(backbone)
    cfg["model"]["neck"]["out_channels"] = WIDTH
    cfg["model"]["bbox_head"].update(in_channels=WIDTH, feat_channels=WIDTH,
                                     point_feat_channels=WIDTH)
    cfg["tpu"].update(max_pos=64, canvas_buckets=[(IMG, IMG)])
    return cfg


def jax_detector(cfg, dtype="float32"):
    return builder.build_detector(Config(cfg), dtype)


def port_detector(cfg, variables):
    model = apis.build_detector(cfg, "float32")
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model.eval()


def assert_close(got, want, rtol=1e-4):
    """got (NCHW tensor) against want (NHWC): max|diff| <= rtol *
    max(1, max|want|)."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    tol = rtol * max(1.0, float(np.abs(want).max()))
    assert err <= tol, (err, tol)


def backbone_weights(ref, x, seed=0):
    """The flax init of one backbone (jitted) with its norms and biases
    perturbed, as numpy."""
    return perturb_norms(numpy_tree(fast_jit(ref.init)(
        jax.random.PRNGKey(seed), x)), np.random.RandomState(seed))


def backbone_pair(ref, port, variables, x, dtype):
    """JAX and port outputs of one backbone on x (NHWC f32) from the same
    weights, the port's input in dtype."""
    port.load_state_dict(flax_to_torch(variables), strict=True)
    outs_ref = fast_jit(ref.apply)(variables, x)
    with torch.no_grad():
        outs = port.eval()(nchw(x).to(dtype))
    return outs, outs_ref


def tree_loads_strictly(cfg, size=64):
    """Every leaf of JAX's build_detector(cfg) tree (shapes from
    jax.eval_shape, no compile; values from a seed) maps to one port
    tensor, which the port's detector takes strictly; returns the port
    model and the tree."""
    shapes = jax.eval_shape(jax_detector(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape, s.dtype), dict(shapes))
    sd = flax_to_torch(tree)
    assert len(sd) == len(jax.tree_util.tree_leaves(tree))
    model = apis.build_detector(cfg, "float32")
    model.load_state_dict(sd, strict=True)
    assert len(model.state_dict()) == len(sd)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    return model, tree


def make_det(cfg, size, seed=0):
    """The JAX detector of cfg and the port's from the same weights, and
    both outputs on a seeded (2, size, size, 3) batch."""
    model_ref = jax_detector(cfg)
    x = np.random.default_rng(seed + 2).normal(
        size=(2, size, size, 3)).astype(np.float32)
    variables = numpy_tree(fast_jit(model_ref.init)(jax.random.PRNGKey(seed),
                                                    jnp.asarray(x)))
    perturb_norms(variables["params"]["backbone"],
                  np.random.RandomState(seed + 1))
    if "batch_stats" in variables:
        perturb_norms(variables["batch_stats"]["backbone"],
                      np.random.RandomState(seed + 1))
    variables = perturb_head(variables, np.random.default_rng(seed),
                             pts_scale=30.0)
    apply = fast_jit(model_ref.apply)
    return dict(cfg=cfg, size=size, variables=variables, apply=apply, x=x,
                outs_ref=apply(variables, jnp.asarray(x)),
                model=port_detector(cfg, variables))


def assert_level_matches(det, key):
    """The five levels at strides 8..128 and the head on them; f32, within
    2e-4 of each output's largest element (test_torch_slice's tolerance:
    two conv libraries' sums, grown through GN)."""
    with torch.no_grad():
        outs = det["model"](torch.from_numpy(det["x"]))
    assert len(outs[key]) == len(det["outs_ref"][key]) == 5
    for lvl, (got, want) in enumerate(zip(outs[key], det["outs_ref"][key])):
        want = np.asarray(want)
        hw = -(-det["size"] // (8 * 2 ** lvl))
        assert want.shape[1:3] == (hw, hw)
        got = got.numpy() if got.shape == want.shape else \
            got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= 2e-4 * max(1.0, np.abs(want).max()), (lvl, err)


def assert_run_inference_matches(det, min_dets=20):
    """apis.run_inference against the JAX model's apply + decode_detections
    with run_inference's batching: scores within 1e-4, polygons within 0.05
    px up to corner order, dets of rounding-close scores matched one to
    one (test_torch_swin's tolerances)."""
    size = det["size"]
    rng = np.random.default_rng(3)
    sizes = ((size, size), (size - 28, size - 60), (size - 64, size))
    ds = [dict(img=rng.normal(size=hw + (3,)).astype(np.float32),
               scale_factor=sf, img_info=dict(file_name=f"im{i}.npy"))
          for i, (hw, sf) in enumerate(zip(sizes, (1.0, 0.75, 1.5)))]
    got = apis.run_inference(det["model"], ds, TC, canvas=(size, size),
                             batch_size=2)
    decode = fast_jit(lambda o, sf: decode_ref(
        o, nms_pre=TC["nms_pre"], score_thr=TC["score_thr"],
        iou_thr=TC["nms"]["iou_thr"], max_per_img=TC["max_per_img"],
        pre_nms_cap=TC["pre_nms_cap"], scale_factor=sf))
    ref = {}
    for lo in (0, 2):
        items = ds[lo:lo + 2]
        x = np.zeros((2, size, size, 3), np.float32)
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
    assert total > min_dets


def one_sgd_step(cfg, variables, batch):
    """One step of build_trainer's recipe on the port and of the JAX train
    step with the same SGD chain (frozen_stages' mask, LR schedule over 10
    iterations an epoch) from the same weights on the same batch: (JAX's
    losses and state dict, the port's)."""
    model_ref = jax_detector(cfg)
    opt, lr = cfg["optimizer"], cfg["lr_config"]
    tx = train_ref.build_optimizer(
        variables["params"], train_ref.lr_schedule(
            base_lr=opt["lr"], warmup_iters=lr["warmup_iters"],
            warmup_ratio=lr["warmup_ratio"], step_epochs=lr["step"],
            iters_per_epoch=10),
        momentum=opt["momentum"], weight_decay=opt["weight_decay"],
        frozen_prefixes=train_ref.default_frozen_prefixes(
            cfg["model"]["backbone"].get("frozen_stages", 1)))
    step_fn = train_ref.make_train_step(
        model_ref, LossConfigRef(max_pos=cfg["tpu"]["max_pos"]),
        img_norm=apis.build_img_norm(cfg))
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = train_ref.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.array,
                                           variables.get("batch_stats", {})),
        opt_state=tx.init(params), tx=tx)
    with jax_fast_compile():
        state, losses = step_fn(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    ref = ({k: float(v) for k, v in losses.items()},
           flax_to_torch({"params": jax.tree_util.tree_map(np.asarray,
                                                           state.params),
                          "batch_stats": variables.get("batch_stats", {})}))
    model = port_detector(cfg, variables)
    _, _, step = apis.build_trainer(model, cfg, iters_per_epoch=10)
    losses = step(batch)
    return ref, ({k: float(v) for k, v in losses.items()},
                 {k: v.detach().clone()
                  for k, v in model.state_dict().items()})


def assert_same_step(variables, ref, got, rtol=3e-2):
    """Losses within rel 1e-4; each tensor's update (new - initial) within
    rtol of that update's largest element plus 1e-7
    (test_torch_train.test_sgd_steps_match's bound); every parameter
    trains (nothing of these backbones is frozen)."""
    (ref_losses, ref_sd), (losses, sd) = ref, got
    assert ref_losses["num_pos"] > 0
    for k, v in ref_losses.items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    sd0 = flax_to_torch(variables)
    assert set(sd) == set(ref_sd) == set(sd0)
    worst = 0.0
    for k, want in ref_sd.items():
        moved, moved_ref = sd[k] - sd0[k], want - sd0[k]
        scale = float(moved_ref.abs().max())
        err = float((moved - moved_ref).abs().max())
        assert err <= rtol * scale + 1e-7, (k, err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


# --------------------------------------------------------------------------
# the backbone
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_weights():
    return backbone_weights(HRNetRef(extra=TINY_EXTRA),
                            np.zeros((1, 64, 64, 3), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [64, 96], ids=["64", "96_odd_stride32"])
def test_backbone_matches(tiny_weights, size, dtype):
    """Four maps at strides 4/8/16/32 with the extra's widths; f32 within
    1e-4 of max(1, the largest element) (test_torch_models' bound), bf16
    within BF16_RTOL of it.  96^2 gives branch maps 24, 12, 6 and 3, so
    the stride-2 chains cross an odd map and the x2 / x4 / x8 upsamples
    start from one."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(
        np.float32)
    ref = HRNetRef(extra=TINY_EXTRA, dtype=jdt)
    port = HRNet(extra=TINY_EXTRA)
    outs, outs_ref = backbone_pair(ref, port, tiny_weights, x, tdt)
    assert port.out_channels == [8, 16, 32, 64]
    assert len(outs) == len(outs_ref) == 4
    for s, c, got, want in zip((4, 8, 16, 32), port.out_channels, outs,
                               outs_ref):
        assert want.shape == (2, size // s, size // s, c)
        assert got.dtype == tdt
        assert_close(got, want, 1e-4 if dtype == "float32" else BF16_RTOL)


def test_backbone_refuses_what_jax_refuses():
    """72^2 gives branch maps 18, 9, 5 and 3: x2 of 5 is 10, not 9, so the
    fusion's sum fails in both packages (HRNet takes multiples of 32)."""
    x = np.zeros((1, 72, 72, 3), np.float32)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(HRNetRef(extra=TINY_EXTRA).init,
                       jax.random.PRNGKey(0), x)
    with pytest.raises(RuntimeError, match="size of tensor"):
        HRNet(extra=TINY_EXTRA)(nchw(x))


def test_w32_tree_converts_and_loads_strictly():
    """The demo config's HRNetV2p-W32 detector (published widths): every
    leaf of the JAX tree maps to one port tensor and loads strictly, the
    stage-4 widths are the FPN's inputs, and the FPN's wiring is
    ResNet's."""
    cfg = load_config(os.path.join(
        REPO, "configs/dota/orientedreppoints_hrnet_w32_demo.py"))
    model, tree = tree_loads_strictly(cfg)
    assert model.backbone.out_channels == [32, 64, 128, 256]
    assert model.neck.start_level == 1 and model.neck.add_extra_convs
    names = set(tree["params"]["backbone"])
    assert {"stem1", "stem2", "layer1", "transition2_0", "transition2_1_0",
            "transition3_2_0", "transition4_3_0", "stage3_3",
            "stage4_2"} <= names
    assert "transition3_0" not in names  # widths kept: no conv


# --------------------------------------------------------------------------
# the detector, run_inference and the SGD step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def det():
    return make_det(narrow_cfg("orientedreppoints_hrnet_w32_demo.py",
                               extra=TINY_EXTRA), IMG)


@pytest.mark.parametrize("key", ["base_feats", "cls_scores", "pts_init",
                                 "pts_refine"])
def test_detector_levels_match(det, key):
    assert_level_matches(det, key)


def test_run_inference_matches_jax(det, jax_ties_first):  # noqa: F811
    assert_run_inference_matches(det)


def test_sgd_step_matches_jax(det):
    """One SGD step (frozen_stages 1 freezes nothing here, as in JAX):
    losses, and every parameter's update within 3e-2 of its largest
    element."""
    ref, got = one_sgd_step(det["cfg"], det["variables"],
                            make_batch(np.random.RandomState(0)))
    assert_same_step(det["variables"], ref, got)


# --------------------------------------------------------------------------
# frozen_stages on every backbone type
# --------------------------------------------------------------------------

TINY_SWIN = dict(embed_dim=16, depths=[2, 2, 2, 2], num_heads=[1, 2, 2, 4])
FROZEN_CASES = {
    "resnet": ("orientedreppoints_r50_demo.py", dict(depth=18)),
    "resnext": ("orientedreppoints_r50_demo.py",
                dict(type="ResNeXt", groups=4, base_width=4)),
    "swin": ("orientedreppoints_swin_tiny_demo.py", TINY_SWIN),
    "hrnet": ("orientedreppoints_hrnet_w32_demo.py", dict(extra=TINY_EXTRA)),
    "ssd_vgg": ("orientedreppoints_ssd_vgg16_demo.py", dict(depth=11)),
}


@pytest.mark.parametrize("frozen_stages", [-1, 1, 3])
@pytest.mark.parametrize("backbone", list(FROZEN_CASES))
def test_frozen_set_matches_jax(backbone, frozen_stages):
    """The parameters build_trainer freezes are, by name, those JAX's
    frozen_stages mask takes out of the optimizer: ResNet's stem and
    layer1 .. layer{frozen_stages}; nothing in Swin, HRNet (whose stem1,
    stem2 and layer1 are not ResNet's names) or SSD-VGG."""
    config, bb = FROZEN_CASES[backbone]
    cfg = narrow_cfg(config, frozen_stages=frozen_stages, **bb)
    shapes = jax.eval_shape(jax_detector(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    dict(shapes)["params"])
    mask = train_ref._frozen_mask(
        params, train_ref.default_frozen_prefixes(frozen_stages))
    frozen = flax_to_torch({"params": jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32), mask, params)})
    want = {k for k, v in frozen.items() if bool(v.all())}
    model = apis.build_detector(cfg, "float32")
    apis.build_trainer(model, cfg)
    got = {k for k, p in model.named_parameters() if not p.requires_grad}
    assert got == want
    assert bool(want) == (backbone in ("resnet", "resnext")
                          and frozen_stages >= 0)


def test_unknown_backbone_raises():
    cfg = narrow_cfg("orientedreppoints_r50_demo.py")
    cfg["model"]["backbone"] = dict(type="MobileNetV2")
    with pytest.raises(NotImplementedError, match="MobileNetV2"):
        apis.build_detector(cfg)
