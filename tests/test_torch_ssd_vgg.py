"""The PyTorch port's SSD-VGG path against the JAX package's, on the CPU.

The backbone (VGG 11 and 16, input_size 300 and 512, at an odd 131^2
with max_outs 5 as the detector builds it, and VGG-11's whole 300 tower
at 300^2), L2Norm in bf16, the demo config's SSD-VGG16@512 tree converted
and loaded strictly (extra0 .. extra5, no 4x4 conv) beside the whole @512
tower's, the detector (FPN and head widths 32, VGG-16) at 128^2, its five
levels and one SGD step of build_trainer's recipe against the JAX step.
Helpers and tolerances: tests/test_torch_hrnet.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.models.ssd_vgg import L2Norm as L2NormRef
from orientedreppoints_tpu.models.ssd_vgg import SSDVGG as SSDVGGRef
from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.models.ssd_vgg import L2Norm, SSDVGG
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_torch_hrnet import one_thread  # noqa: F401
from test_torch_hrnet import (IMG, REPO, assert_close, assert_level_matches,
                              assert_same_step, backbone_pair,
                              backbone_weights, make_det, narrow_cfg,
                              one_sgd_step, tree_loads_strictly)
from test_torch_train import make_batch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SSD_DEMO = "orientedreppoints_ssd_vgg16_demo.py"


@pytest.mark.parametrize("depth, input_size, size, max_outs", [
    (11, 300, 131, 5), (11, 512, 131, 5), (16, 300, 131, 5),
    (16, 512, 131, 5), (11, 300, 300, None)],
    ids=["vgg11_300", "vgg11_512", "vgg16_300", "vgg16_512",
         "vgg11_300_whole_tower"])
def test_backbone_matches(depth, input_size, size, max_outs):
    """Every map within 1e-4 of max(1, its largest element) (f32).  At
    131^2 the 2x2 ceil_mode pools meet odd maps (131 -> 66 -> 33 -> 17 ->
    9), and the five maps are 17, 9, 5, 3 and 1 (@300: its stride-1 3x3
    extra) or 2 (@512); 300^2 runs the whole 300 tower to its 1^2 map."""
    x = np.random.default_rng(size).normal(size=(1, size, size, 3)).astype(
        np.float32)
    ref = SSDVGGRef(input_size=input_size, depth=depth, max_outs=max_outs)
    port = SSDVGG(input_size=input_size, depth=depth, max_outs=max_outs)
    variables = backbone_weights(ref, x)
    outs, outs_ref = backbone_pair(ref, port, variables, x, torch.float32)
    assert len(outs) == len(outs_ref) == len(port.out_channels)
    assert len(outs) == (5 if max_outs else 6)
    assert [o.shape[-1] for o in outs_ref] == port.out_channels
    for got, want in zip(outs, outs_ref):
        assert_close(got, want)
    # 131: 17, 9, 5, 3, then @300 a padding-0 3x3 to 1, @512 stride 2 to 2
    if max_outs:
        last = 1 if input_size == 300 else 2
        assert [o.shape[1] for o in outs_ref] == [17, 9, 5, 3, last]


def test_l2norm_bf16_matches():
    """L2Norm on a bf16 map: computed in f32 (w * x / (||x|| + eps)), cast
    back to bf16; within one bf16 rounding (2^-8) of the largest element
    (the channel sum runs in another order), and the weight's init is the
    scale."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 7, 9, 48)), jnp.bfloat16)
    ref = L2NormRef(scale=20.0)
    variables = ref.init(jax.random.PRNGKey(0), x)
    w = rng.uniform(5, 30, 48).astype(np.float32)
    want = np.asarray(ref.apply({"params": {"weight": w}}, x), np.float32)
    port = L2Norm(48, 20.0)
    assert torch.equal(port.weight, torch.from_numpy(
        np.asarray(variables["params"]["weight"])))
    port.weight.data = torch.from_numpy(w)
    xt = torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2).to(
        torch.bfloat16)
    got = port(xt)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, 2.0 ** -8)


@pytest.mark.parametrize("max_outs", [5, None], ids=["detector", "tower"])
def test_tree_converts_and_loads_strictly(max_outs):
    """The demo config's detector (SSD-VGG16@512, published widths, its
    neck at start_level 0 without extra levels): every leaf maps to one
    port tensor and loads strictly; its backbone holds extra0 .. extra5
    and no 4x4 conv.  The @512 tower without max_outs holds extra0 ..
    extra8 and the 4x4 extra9, in both packages."""
    cfg = load_config(os.path.join(REPO, "configs/dota", SSD_DEMO))
    if max_outs:
        model, tree = tree_loads_strictly(cfg)
        names = set(tree["params"]["backbone"])
        assert model.backbone.out_channels == [512, 1024, 512, 256, 256]
        assert model.neck.start_level == 0
        assert not model.neck.add_extra_convs
        assert {f"extra{i}" for i in range(6)} <= names
        assert "extra6" not in names
        return
    shapes = jax.eval_shape(SSDVGGRef(input_size=512).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 512, 512, 3), jnp.float32))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  dict(shapes))
    port = SSDVGG(input_size=512)
    port.load_state_dict(flax_to_torch(tree), strict=True)
    assert tree["params"]["extra9"]["kernel"].shape == (4, 4, 128, 256)
    assert "extra10" not in tree["params"]
    assert port.out_channels == [512, 1024, 512, 256, 256, 256, 256]


@pytest.fixture(scope="module")
def det():
    return make_det(narrow_cfg(SSD_DEMO), IMG)


@pytest.mark.parametrize("key", ["base_feats", "cls_scores", "pts_init",
                                 "pts_refine"])
def test_detector_levels_match(det, key):
    """The @512 tower's first five maps at 128^2 (16, 8, 4, 2, 1), the FPN
    over all five (its 1 -> 2 top-down step through nearest-exact)."""
    assert_level_matches(det, key)


def test_sgd_step_matches_jax(det):
    """One SGD step (frozen_stages 1 freezes nothing in VGG, as in JAX):
    losses, and every parameter's update within 3e-2 of its largest
    element."""
    ref, got = one_sgd_step(det["cfg"], det["variables"],
                            make_batch(np.random.RandomState(0)))
    assert_same_step(det["variables"], ref, got)
