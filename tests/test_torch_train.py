"""The PyTorch port's training step against the JAX package's, on the CPU.

An R-18 detector with narrow widths (FPN and head channels 32) at 128^2,
batch 2, MAX_GT 8, max_pos 64 (tests/test_train.py's sizes): the JAX
model's initial weights with the head perturbed (test_torch_slice.
perturb_head: with std-0.01 point convs all 9 points coincide and the
refine assigner degenerates) go through flax_to_torch into the port.
Checked, all in f32 unless named: the paired-DCN autograd node and its
plain backward against jax.vjp (also in bf16); compute_losses and its
grads on the same head outputs; one and two SGD steps from the same
weights; the LR schedule and device_normalize.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.core.loss_head import LossConfig as LossConfigRef
from orientedreppoints_tpu.core.loss_head import \
    compute_losses as compute_losses_ref
from orientedreppoints_tpu.models import OrientedRepPointsDetector
from orientedreppoints_tpu.ops import deform_conv as dcn_ref
from orientedreppoints_tpu.parallel import train as train_ref
from orientedreppoints_tpu_torch.apis import (build_detector,
                                              build_img_norm,
                                              build_loss_config)
from orientedreppoints_tpu_torch.core.loss_head import (LossConfig,
                                                        compute_losses)
from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.ops import deform_conv
from orientedreppoints_tpu_torch.parallel import train
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_torch_slice import perturb_head


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IMG = 128
MAX_GT = 8
WIDTH = 32
R50 = "configs/dota/orientedreppoints_r50_demo.py"
HEAD_KEYS = ("cls_scores", "pts_init", "pts_refine")


def make_batch(rng, b=2):
    """test_train.make_batch's rotated gts (1-3 per image), uint8 images
    (normalized on the device) and true sizes inside the canvas."""
    gt_polys = np.zeros((b, MAX_GT, 8), np.float32)
    gt_labels = np.zeros((b, MAX_GT), np.int32)
    gt_valid = np.zeros((b, MAX_GT), bool)
    for i in range(b):
        for j in range(rng.randint(1, 4)):
            cx, cy = rng.rand(2) * 80 + 24
            w, h = rng.rand(2) * 40 + 10
            a = rng.rand() * np.pi
            c, s = np.cos(a), np.sin(a)
            r = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2],
                          [-w / 2, h / 2]])
            gt_polys[i, j] = ((r @ [[c, s], [-s, c]]) + [cx, cy]).reshape(-1)
            gt_labels[i, j] = rng.randint(1, 16)
            gt_valid[i, j] = True
    return dict(images=(rng.rand(b, IMG, IMG, 3) * 255).astype(np.uint8),
                gt_polys=gt_polys, gt_labels=gt_labels, gt_valid=gt_valid,
                img_hw=np.array([[IMG, IMG], [112, 96]][:b], np.int32))


@pytest.fixture(scope="module")
def setup():
    cfg = load_config(R50)
    cfg["model"]["backbone"]["depth"] = 18
    cfg["model"]["neck"]["out_channels"] = WIDTH
    head = cfg["model"]["bbox_head"]
    head.update(in_channels=WIDTH, feat_channels=WIDTH,
                point_feat_channels=WIDTH)
    cfg["tpu"]["max_pos"] = 64
    model_ref = OrientedRepPointsDetector(
        depth=18, num_classes=16, fpn_out_channels=WIDTH,
        head_kwargs=dict(feat_channels=WIDTH, point_feat_channels=WIDTH))
    variables = model_ref.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    variables = perturb_head(jax.tree_util.tree_map(np.array,
                                                    dict(variables)),
                             np.random.default_rng(0))
    img_norm = build_img_norm(cfg)
    batch = make_batch(np.random.RandomState(0))
    return dict(cfg=cfg, model_ref=model_ref, variables=variables,
                img_norm=img_norm, batch=batch)


@contextlib.contextmanager
def jax_fast_compile():
    """Compile the JAX side without most XLA:CPU optimisation passes: the
    numbers are the same within the tolerances below, and the compiles of
    compute_losses' grad and of the train step take about half the time."""
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


def port_model(setup):
    model = build_detector(setup["cfg"], "float32")
    model.load_state_dict(flax_to_torch(setup["variables"]), strict=True)
    return model


def test_config_readers_match():
    from orientedreppoints_tpu.utils import Config, builder

    cfg_ref = Config.fromfile(R50)
    cfg = load_config(R50)
    assert dataclass_dict(build_loss_config(cfg)) == dataclass_dict(
        builder.build_loss_config(cfg_ref))
    assert build_loss_config(cfg).max_pos == 1024
    assert build_img_norm(cfg) == builder.build_img_norm(cfg_ref)


def dataclass_dict(x):
    return {k: tuple(v) if isinstance(v, (list, tuple)) else v
            for k, v in vars(x).items()}


def test_dcn_autograd_node_and_plain_backward():
    """The port's paired DCN is one autograd node (the DCN branch's grads
    reach the towers and the offsets on every device), and its plain
    backward with autograd's matmul grads equals jax.vjp of the JAX
    deform_conv2d_pyramid_pair in f32."""
    rng = np.random.default_rng(1)
    b, c, cout = 2, 16, 8
    hws = [(8, 10), (4, 5), (2, 3), (1, 2)]
    fa = [rng.normal(size=(b, h, w, c)).astype(np.float32) for h, w in hws]
    fb = [rng.normal(size=(b, h, w, c)).astype(np.float32) for h, w in hws]
    off = [(rng.normal(size=(b, h, w, 18)) * 2).astype(np.float32)
           for h, w in hws]
    wa = rng.normal(size=(9, c, cout)).astype(np.float32)
    wb = rng.normal(size=(9, c, cout)).astype(np.float32)
    ga = [rng.normal(size=(b, h, w, cout)).astype(np.float32) for h, w in hws]
    gb = [rng.normal(size=(b, h, w, cout)).astype(np.float32) for h, w in hws]

    @jax.jit
    def grads(inputs, cot):
        return jax.vjp(dcn_ref.deform_conv2d_pyramid_pair, *inputs)[1](cot)

    ref = jax.tree_util.tree_leaves(grads((fa, fb, off, wa, wb), (ga, gb)))

    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in fa + fb + off + [wa, wb]]
    n = len(hws)
    outs_a, outs_b = deform_conv.deform_conv2d_pyramid_pair(
        leaves[:n], leaves[n:2 * n], leaves[2 * n:3 * n], leaves[-2],
        leaves[-1])
    # every level's output comes out of the matmul over one sampling node
    node = outs_a[0].grad_fn
    while node is not None and "DeformSamplePair" not in type(node).__name__:
        node = node.next_functions[0][0]
    assert node is not None, "no DeformSamplePair node behind the output"
    torch.autograd.backward(
        outs_a + outs_b, [torch.from_numpy(g) for g in ga + gb])
    assert len(ref) == len(leaves)
    # f32 gathers and scatters, K*C-term products in another order
    for got, want in zip(leaves, ref):
        want = np.asarray(want)
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        assert got.grad is not None
        assert np.abs(got.grad.numpy() - want).max() <= tol


def test_dcn_autograd_node_bf16_matches_jax_vjp():
    """bf16 features, offsets and output grads, f32 weights, as the head
    runs in bf16: the node's weight grads are f32 sums returned in f32 (not
    rounded to bf16), as the JAX package's _pair_core_bwd returns them, and
    every grad agrees with jax.vjp of deform_conv2d_pyramid_pair within the
    rounding that the two place differently."""
    rng = np.random.default_rng(1)
    b, c, cout = 2, 16, 8
    hws = [(8, 10), (4, 5), (2, 3), (1, 2)]
    fa = [rng.normal(size=(b, h, w, c)).astype(np.float32) for h, w in hws]
    fb = [rng.normal(size=(b, h, w, c)).astype(np.float32) for h, w in hws]
    off = [(rng.normal(size=(b, h, w, 18)) * 2).astype(np.float32)
           for h, w in hws]
    wa = rng.normal(size=(9, c, cout)).astype(np.float32)
    wb = rng.normal(size=(9, c, cout)).astype(np.float32)
    ga = [rng.normal(size=(b, h, w, cout)).astype(np.float32) for h, w in hws]
    gb = [rng.normal(size=(b, h, w, cout)).astype(np.float32) for h, w in hws]

    def bf(xs):
        return [jnp.asarray(x, jnp.bfloat16) for x in xs]

    @jax.jit
    def grads(inputs, cot):
        return jax.vjp(dcn_ref.deform_conv2d_pyramid_pair, *inputs)[1](cot)

    ref = jax.tree_util.tree_leaves(grads(
        (bf(fa), bf(fb), bf(off), jnp.asarray(wa), jnp.asarray(wb)),
        (bf(ga), bf(gb))))

    def tbf(x):
        return torch.from_numpy(x).to(torch.bfloat16)

    leaves = ([tbf(x).requires_grad_(True) for x in fa + fb + off]
              + [torch.from_numpy(x).requires_grad_(True) for x in (wa, wb)])
    n = len(hws)
    outs_a, outs_b = deform_conv.deform_conv2d_pyramid_pair(
        leaves[:n], leaves[n:2 * n], leaves[2 * n:3 * n], leaves[-2],
        leaves[-1])
    torch.autograd.backward(outs_a + outs_b, [tbf(g) for g in ga + gb])
    for w in leaves[-2:]:
        assert w.grad.dtype == torch.float32
        assert not torch.equal(w.grad, w.grad.to(torch.bfloat16).float())
    # relative to each grad's largest element.  Tables: the JAX package
    # scatter-adds in bf16 (up to 36 roundings of a value), the port sums in
    # f32 and rounds once (measured 1.4e-2).  Offsets: both round the sum to
    # bf16 (2^-8 of a value), and JAX forms the corner differences in bf16
    # (measured 6.5e-3).  Weights: JAX lerps the samples in bf16, the port
    # in f32 with one rounding, and both sum cols^T g in f32 (measured
    # 4.7e-3).
    tols = [3e-2] * (2 * n) + [1e-2] * n + [1e-2] * 2
    for got, want, tol in zip(leaves, ref, tols):
        want = np.asarray(want).astype(np.float32)
        assert got.grad.dtype == got.dtype
        err = np.abs(got.grad.float().numpy() - want).max()
        assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


LOSS_INPUTS = ("gt_polys", "gt_labels", "gt_valid", "img_hw")


@pytest.fixture(scope="module")
def jax_head(setup):
    """batch -> the JAX model's head outputs on it, and the JAX loss dict
    and grads with respect to the head outputs.  The forward and the grad
    are jitted once with the batch as arguments, so every batch of
    setup's shapes reuses their compiles."""
    cfg = LossConfigRef(max_pos=64)

    def total(head, base, *gts):
        losses = compute_losses_ref(dict(head, base_feats=base), *gts, cfg)
        return sum(v for k, v in losses.items()
                   if k.startswith("loss")), losses

    forward = jax.jit(setup["model_ref"].apply)
    grad = jax.jit(jax.value_and_grad(total, has_aux=True))

    def run(batch):
        imgs = train_ref.device_normalize(jnp.asarray(batch["images"]),
                                          jnp.asarray(batch["img_hw"]),
                                          **setup["img_norm"])
        with jax_fast_compile():
            outs = forward(setup["variables"], imgs)
        outs = {k: [np.asarray(x) for x in v] for k, v in outs.items()}
        with jax_fast_compile():
            (_, losses), grads = grad(
                {k: outs[k] for k in HEAD_KEYS}, outs["base_feats"],
                *(jnp.asarray(batch[k]) for k in LOSS_INPUTS))
        return outs, {k: float(v) for k, v in losses.items()}, grads
    return run


@pytest.fixture(scope="module")
def head_case(setup, jax_head):
    """jax_head on setup's batch."""
    return jax_head(setup["batch"])


def port_loss_grads(outs, batch, stats=None):
    """The port's compute_losses on the JAX head outputs, backward from
    the total -> (loss dict, head outputs with their grads)."""
    head = {k: [torch.from_numpy(x).requires_grad_(True) for x in outs[k]]
            for k in HEAD_KEYS}
    losses = compute_losses(
        dict(head, base_feats=[torch.from_numpy(x)
                               for x in outs["base_feats"]]),
        *(torch.from_numpy(batch[k]) for k in LOSS_INPUTS),
        LossConfig(max_pos=64), stats=stats)
    sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    return losses, head


def test_compute_losses_matches_on_the_same_head_outputs(setup, head_case):
    outs, ref, ref_grads = head_case
    stats = {}
    losses, head = port_loss_grads(outs, setup["batch"], stats)
    # a real assignment: the refine assigner did not degenerate
    assert 0 < ref["num_pos"] < ref["num_assigned_pos"]
    assert (stats["iou_gt_0p1"] > 0).all()
    assert set(losses) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k in HEAD_KEYS:
        for got, want in zip(head[k], ref_grads[k]):
            want = np.asarray(want)
            tol = 1e-4 * max(1e-3, float(np.abs(want).max()))
            assert np.abs(got.grad.numpy() - want).max() <= tol, k


def test_empty_gt_images_stay_finite(setup, head_case):
    """All gts padded: no positives, every loss finite, cls loss zeroed
    (the reference zeroes it without positives), grads finite."""
    outs, _, _ = head_case
    batch = setup["batch"]
    head = {k: [torch.from_numpy(x).requires_grad_(True) for x in outs[k]]
            for k in HEAD_KEYS}
    losses = compute_losses(
        dict(head, base_feats=[torch.from_numpy(x)
                               for x in outs["base_feats"]]),
        torch.from_numpy(batch["gt_polys"]),
        torch.from_numpy(batch["gt_labels"]),
        torch.zeros(batch["gt_valid"].shape, dtype=torch.bool),
        torch.from_numpy(batch["img_hw"]), LossConfig(max_pos=64))
    assert all(torch.isfinite(v).all() for v in losses.values())
    assert float(losses["num_pos"]) == 0 and float(losses["loss_cls"]) == 0
    sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    assert all(torch.isfinite(x.grad).all() for k in HEAD_KEYS
               for x in head[k] if x.grad is not None)


@pytest.fixture(scope="module")
def jax_trainer(setup):
    """The JAX optimizer and jitted train step, built once: every test
    that steps through them with setup's batch shapes reuses one compile."""
    tx = train_ref.build_optimizer(
        setup["variables"]["params"],
        train_ref.lr_schedule(iters_per_epoch=10),
        frozen_prefixes=train_ref.default_frozen_prefixes(1))
    step_fn = train_ref.make_train_step(
        setup["model_ref"], LossConfigRef(max_pos=64),
        img_norm=setup["img_norm"])
    return tx, step_fn


def jax_steps(setup, jax_trainer, n_steps, batch):
    """n SGD steps of the JAX train step; losses and params after each."""
    variables = setup["variables"]
    tx, step_fn = jax_trainer
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = train_ref.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.array,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(n_steps):
        with jax_fast_compile():
            state, losses = step_fn(state, batch)
        out.append(({k: float(v) for k, v in losses.items()},
                    flax_to_torch({"params": jax.tree_util.tree_map(
                        np.asarray, state.params),
                        "batch_stats": variables["batch_stats"]})))
    return out


def port_steps(setup, n_steps, batch):
    model = port_model(setup)
    train.freeze(model, train.default_frozen_prefixes(1))
    opt, sched = train.build_optimizer(
        model, train.lr_schedule(iters_per_epoch=10))
    step = train.make_train_step(model, build_loss_config(setup["cfg"]), opt,
                                 sched, img_norm=setup["img_norm"])
    out = []
    for _ in range(n_steps):
        losses = step(batch)
        out.append(({k: float(v) for k, v in losses.items()},
                    {k: v.detach().clone()
                     for k, v in model.state_dict().items()}))
    return out


@pytest.fixture(scope="module")
def two_steps(setup, jax_trainer):
    return (jax_steps(setup, jax_trainer, 2, setup["batch"]),
            port_steps(setup, 2, setup["batch"]))


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_steps"])
def test_sgd_steps_match(setup, two_steps, step):
    """Losses within rel 1e-4.  Each parameter's update (new - initial)
    within 3e-2 of that update's largest element, plus 1e-7: the two
    frameworks' f32 convolutions and GroupNorm backward round differently
    (~1e-6 of a grad), the clip and the LR scale that alike, and the second
    step starts from parameters that already differ (measured: 1.2e-2 at
    worst, a GN affine of the FPN)."""
    assert_same_step(setup, two_steps[0][step], two_steps[1][step])


def assert_same_step(setup, ref, got, wide=None):
    """test_sgd_steps_match's tolerances; the tensors named by wide
    (prefix -> update rtol) get theirs."""
    (ref_losses, ref_sd), (losses, sd) = ref, got
    assert ref_losses["num_pos"] > 0
    for k, v in ref_losses.items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    sd0 = flax_to_torch(setup["variables"])
    frozen = tuple(train.default_frozen_prefixes(1))
    for k, want in ref_sd.items():
        moved, moved_ref = sd[k] - sd0[k], want - sd0[k]
        rtol = next((r for p, r in (wide or {}).items()
                     if k.startswith(p)), 3e-2)
        tol = rtol * float(moved_ref.abs().max()) + 1e-7
        assert float((moved - moved_ref).abs().max()) <= tol, k
        if k.startswith(frozen):
            assert torch.equal(sd[k], sd0[k]), k  # frozen: bitwise
    # F1: layer2's frozen-BN affine trains (checked above), as in JAX
    for k in ("backbone.layer2_0.conv1.bn.scale",
              "backbone.layer2_0.conv1.bn.bias"):
        assert (ref_sd[k] != sd0[k]).any() and (sd[k] != sd0[k]).any(), k


@pytest.fixture(scope="module")
def loader_batch(tmp_path_factory):
    """The first batch of the port's DataLoader over the tiles of one
    256^2 scene (seed 0) through synth_r18_512.py's train pipeline at scale
    128, normalized on the device: setup's batch shapes."""
    from orientedreppoints_tpu_torch.apis import build_dataset
    from orientedreppoints_tpu_torch.data.loader import DataLoader
    from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit

    root = tmp_path_factory.mktemp("loader_batch")
    generate_synth_dota(str(root / "raw"), 1, size=256, seed=0, prefix="T")
    ImgSplit(str(root / "raw"), str(root / "split"), gap=64,
             subsize=128, ext=".npy", num_process=1).splitdata()
    pipeline = [dict(s, img_scale=(128, 128)) if s["type"] == "RotateResize"
                else s for s in load_config(
                    "configs/dota/synth_r18_512.py")["train_pipeline"]]
    ds = build_dataset(dict(
        type="DotaDataset", pipeline=pipeline,
        ann_file=dota2coco_train(str(root / "split"), str(root / "s.json"),
                                 ext=".npy"),
        img_prefix=str(root / "split" / "images")), device_normalize=True)
    batch = next(iter(DataLoader(ds, 2, canvas_buckets=[(IMG, IMG)],
                                 max_gt=MAX_GT)))
    assert {k: (v.shape, v.dtype) for k, v in batch.items()} == {
        k: (v.shape, v.dtype) for k, v in make_batch(
            np.random.RandomState(0)).items()}
    return batch


def test_sgd_step_on_the_first_loader_batch(setup, jax_trainer, jax_head,
                                            loader_batch):
    """One SGD step on the loader's first batch (rendered tiles, the train
    pipeline, collate; 10 gts, 209 assigned positives of which 81 past
    max_pos) from the same weights: the JAX train step and the port's.
    First the port's own part: compute_losses on the JAX head outputs, its
    losses within rel 1e-5 and its grads with respect to the head outputs
    within 1e-5 of each output's largest grad over its levels (measured:
    1.8e-7).  Then the step, with test_sgd_steps_match's tolerances (losses
    within rel 1e-4, each parameter's update within 3e-2 of its largest
    element, plus 1e-7; measured 1.9e-2 at most) except on the cls tower's
    first conv and GN, held at 6e-2: measured 4.7e-2 on its weight and
    3.9e-2 on its GN bias, whose updates are small sums of the focal grads
    of every location (largest 5.6e-5 and 3.9e-6) that cancel, so the two
    frameworks' f32 conv, GN and DCN backward orders show."""
    assert loader_batch["gt_valid"].sum() >= 4
    outs, ref, ref_grads = jax_head(loader_batch)
    losses, head = port_loss_grads(outs, loader_batch)
    for k, v in ref.items():
        np.testing.assert_allclose(float(losses[k]), v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k in HEAD_KEYS:
        scale = max(float(np.abs(np.asarray(w)).max()) for w in ref_grads[k])
        for got, want in zip(head[k], ref_grads[k]):
            err = float(np.abs(got.grad.numpy() - np.asarray(want)).max())
            assert err <= 1e-5 * scale, (k, err, scale)
    assert_same_step(setup,
                     jax_steps(setup, jax_trainer, 1, loader_batch)[0],
                     port_steps(setup, 1, loader_batch)[0],
                     wide={"bbox_head.cls_conv_0.": 6e-2})


def test_lr_schedule_equal():
    ref = train_ref.lr_schedule(base_lr=0.008, iters_per_epoch=100)
    got = train.lr_schedule(base_lr=0.008, iters_per_epoch=100)
    steps = [0, 1, 7, 250, 499, 500, 501, 2399, 2400, 3199, 3200, 3800, 9999]
    assert [got(s) for s in steps] == [
        float(ref(jnp.asarray(s))) for s in steps]


def test_device_normalize_equal(setup):
    batch = setup["batch"]
    ref = train_ref.device_normalize(jnp.asarray(batch["images"]),
                                     jnp.asarray(batch["img_hw"]),
                                     **setup["img_norm"])
    got = train.device_normalize(torch.from_numpy(batch["images"]),
                                 torch.from_numpy(batch["img_hw"]),
                                 **setup["img_norm"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[1, 112:] == 0).all() and (got[1, :, 96:] == 0).all()
