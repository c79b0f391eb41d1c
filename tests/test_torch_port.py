"""The PyTorch port's boundaries: it runs without JAX, flax or cv2; the
R-50 demo model's flax tree converts completely; CUDA-only entries raise
without a GPU; CPU tensors never reach a kernel."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.utils import Config, builder
from orientedreppoints_tpu_torch import ops
from orientedreppoints_tpu_torch.apis import build_detector
from orientedreppoints_tpu_torch.models.detector import decode_detections
from orientedreppoints_tpu_torch.ops import (deform_conv, hull_iou,
                                             minarearect, quad_iou)
from orientedreppoints_tpu_torch.serving import Predictor
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R50 = os.path.join(REPO, "configs/dota/orientedreppoints_r50_demo.py")

NO_JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    from orientedreppoints_tpu_torch.serving import Predictor
    cfg = dict(
        model=dict(backbone=dict(type="ResNet", depth=18),
                   neck=dict(out_channels=32, num_outs=5),
                   bbox_head=dict(num_classes=16, feat_channels=32,
                                  point_feat_channels=32)),
        test_cfg=dict(nms_pre=50, score_thr=0.0, nms=dict(iou_thr=0.4),
                      max_per_img=20, pre_nms_cap=64),
        img_norm_cfg=dict(mean=[0, 0, 0], std=[1, 1, 1], to_rgb=True),
        data=dict(test=dict(pipeline=[dict(type="RotateResize",
                                           img_scale=(64, 64))])),
        tpu=dict(canvas_buckets=[(64, 64)]),
    )
    pred = Predictor(cfg, batch_size=2, compute_dtype="float32",
                     device="cpu")
    out = pred([np.zeros((50, 64, 3), np.uint8)])
    assert len(out) == 1 and len(out[0]) == 15
    assert sum(len(a) for a in out[0]) > 0
    # the training step: losses, assigners, APAA, SGD
    from orientedreppoints_tpu_torch.core.loss_head import LossConfig
    from orientedreppoints_tpu_torch.parallel import train
    model = pred.model
    train.freeze(model, train.default_frozen_prefixes(1))
    opt, sched = train.build_optimizer(model, train.lr_schedule())
    step = train.make_train_step(model, LossConfig(max_pos=16), opt, sched)
    quad = np.float32([[10, 10, 40, 12, 38, 30, 9, 28]])
    losses = step(dict(images=np.zeros((2, 64, 64, 3), np.float32),
                       gt_polys=np.stack([quad, quad]),
                       gt_labels=np.int32([[3], [4]]),
                       gt_valid=np.ones((2, 1), bool),
                       img_hw=np.int32([[64, 64], [64, 48]])))
    assert np.isfinite(float(losses["loss_total"]))
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "cv2",
                                           "orientedreppoints_tpu"))
    print("LOADED", loaded)
    assert not loaded, loaded
""")


def test_port_runs_without_jax_flax_cv2():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_r50_demo_tree_converts_and_loads_strictly():
    cfg = Config.fromfile(R50)
    model = builder.build_detector(cfg, "float32")
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))
    sd = flax_to_torch(tree)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    assert len(sd) == n_leaves
    torch_model = build_detector({k: cfg.get(k) for k in ("model",)},
                                 "float32")
    torch_model.load_state_dict(sd, strict=True)  # no key missing or extra
    assert len(torch_model.state_dict()) == n_leaves


def test_cuda_entries_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(R50, device="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        minarearect.min_area_rect_kernel(torch.zeros(4, 18))
    with pytest.raises(ValueError, match="CUDA tensor"):
        quad_iou.quad_over_mask_kernel(torch.zeros(1, 8, 8), 0.4,
                                       torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hull_iou.hull_quad_iou_kernel(torch.zeros(1, 4, 9, 2),
                                      torch.ones(1, 4, dtype=torch.int32),
                                      torch.zeros(1, 3, 8))
    t = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        deform_conv.deform_sample_pair_backward_kernel(
            t, t, torch.zeros(6, 18), torch.zeros(6, 36), torch.zeros(6, 36),
            [(1, 2, 3)])


def test_cpu_tensors_never_launch_a_kernel():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    b, h, w = 2, 6, 5
    outs = {
        "cls_scores": [torch.from_numpy(rng.normal(size=(b, h, w, 15))
                                        .astype(np.float32))],
        "pts_refine": [torch.from_numpy(rng.normal(size=(b, h, w, 18))
                                        .astype(np.float32))],
    }
    dets, labels, valid = decode_detections(outs, strides=(8,), nms_pre=20,
                                            max_per_img=10, pre_nms_cap=64)
    assert valid.any()
    t = torch.from_numpy(rng.normal(size=(b * h * w, 16)).astype(np.float32))
    off = torch.zeros(b * h * w, 18)
    deform_conv.deform_sample_pair(t, t, off, [(b, h, w)])
    g = torch.ones(b * h * w, 9 * 16)
    deform_conv.deform_sample_pair_backward(t, t, off, g, g, [(b, h, w)])
    hulls, counts = minarearect.convex_hull_entry(
        torch.from_numpy(rng.normal(size=(4, 18)).astype(np.float32)))
    hull_iou.hull_quad_iou_matrix(hulls[None], counts[None],
                                  torch.zeros(1, 3, 8))
    assert len(ops.KERNELS) == 6
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
