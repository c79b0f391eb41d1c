"""The PyTorch port's layers, ResNet and FPN against the JAX modules.

Same numpy inputs (seeded) and the same weights (the flax tree, perturbed so
that frozen BN is not the identity, converted by flax_to_torch); f32 on the
CPU.  Tolerance: max|diff| <= 1e-4 * max(1, max|ref|), the f32 rounding of
two convolution implementations summing in different orders.
"""

import jax
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.models.fpn import FPN as FPNRef
from orientedreppoints_tpu.models.layers import ConvModule as ConvModuleRef
from orientedreppoints_tpu.models.layers import FrozenBatchNorm as BNRef
from orientedreppoints_tpu.models.resnet import ResNet as ResNetRef
from orientedreppoints_tpu_torch.models.fpn import FPN
from orientedreppoints_tpu_torch.models.layers import ConvModule, FrozenBatchNorm
from orientedreppoints_tpu_torch.models.resnet import ResNet
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(variables):
    return jax.tree_util.tree_map(np.array, dict(variables))


def perturb_norms(tree, rng):
    """Random frozen-BN statistics and norm affines, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            perturb_norms(v, rng)
        elif k == "var":
            tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k in ("mean", "scale", "bias") and v.ndim == 1:
            tree[k] = (v + rng.normal(0, 0.2, v.shape)).astype(np.float32)
    return tree


def init_pair(ref_module, torch_module, inputs, seed=0):
    variables = ref_module.init(jax.random.PRNGKey(seed), *inputs)
    variables = perturb_norms(numpy_tree(variables),
                              np.random.RandomState(seed))
    torch_module.load_state_dict(flax_to_torch(variables), strict=True)
    return variables, torch_module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_close_nhwc(out_nchw, ref_nhwc):
    ref = np.asarray(ref_nhwc)
    got = out_nchw.detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("act", [True, False])
def test_conv_module(act):
    x = np.random.RandomState(3).randn(2, 9, 11, 16).astype(np.float32)
    ref = ConvModuleRef(32, 3, norm="gn", act=act)
    v, mod = init_pair(ref, ConvModule(16, 32, 3, act=act), [x])
    assert_close_nhwc(mod(nchw(x)), ref.apply(v, x))


@pytest.mark.parametrize("act", [True, False])
def test_conv_module_one_value_a_group(act):
    """Width 32 in 32 groups, batch 1, a 1x1 map: each group holds one
    value, which flax normalises to the bias (F.group_norm refuses it)."""
    x = np.random.RandomState(5).randn(1, 1, 1, 16).astype(np.float32)
    ref = ConvModuleRef(32, 3, norm="gn", act=act)
    v, mod = init_pair(ref, ConvModule(16, 32, 3, act=act), [x])
    bias = v["params"]["gn"]["bias"]
    assert np.abs(bias).min() > 0
    want = np.asarray(ref.apply(v, x))
    got = mod(nchw(x)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 1, 1, 32)
    assert float(np.abs(got - want).max()) <= 1e-6
    np.testing.assert_allclose(want[0, 0, 0], np.maximum(bias, 0) if act
                               else bias, atol=1e-6)


def test_frozen_batch_norm():
    x = np.random.RandomState(4).randn(2, 5, 7, 24).astype(np.float32)
    ref = BNRef(24)
    v, mod = init_pair(ref, FrozenBatchNorm(24), [x])
    assert_close_nhwc(mod(nchw(x)), ref.apply(v, x))
    # the affine trains (flax "params"), the statistics do not
    assert {n for n, _ in mod.named_parameters()} == {"scale", "bias"}
    assert {n for n, _ in mod.named_buffers()} == {"mean", "var"}


@pytest.mark.parametrize("depth, kw", [
    (18, {}), (50, {}),
    (50, dict(groups=4, base_width=4, out_indices=(1, 2, 3)))],
    ids=["18", "50", "resnext50_4x4d_c3_c5"])
def test_resnet(depth, kw):
    """ResNet, and ResNeXt (groups 4, base width 4: conv2 grouped, widths
    int(64 * 4 / 64) * 4 = 16 .. 128) returning C3..C5 only."""
    x = np.random.RandomState(5).randn(1, 64, 64, 3).astype(np.float32)
    ref = ResNetRef(depth=depth, **kw)
    v, mod = init_pair(ref, ResNet(depth, **kw), [x])
    outs_ref = ref.apply(v, x)
    with torch.no_grad():
        outs = mod(nchw(x))
    n = len(kw.get("out_indices", range(4)))
    assert len(outs) == len(outs_ref) == len(mod.out_channels) == n
    for o, r, c in zip(outs, outs_ref, mod.out_channels):
        assert r.shape[-1] == c
        assert_close_nhwc(o, r)


@pytest.mark.parametrize("c3_hw", [(12, 20), (63, 125)],
                         ids=["canvas96x160", "odd_upsample"])
def test_fpn(c3_hw):
    """(12, 20) is C3 of a 96x160 canvas (not a multiple of 64); (63, 125)
    gives the 32->63 and 63->125 upsamples where nearest != nearest-exact."""
    rng = np.random.RandomState(6)
    h, w = c3_hw
    chans = [16, 32, 64, 128]
    hws = [(2 * h, 2 * w), (h, w), ((h + 1) // 2, (w + 1) // 2),
           ((h + 3) // 4, (w + 3) // 4)]
    feats = [rng.randn(1, a, b, c).astype(np.float32)
             for (a, b), c in zip(hws, chans)]
    ref = FPNRef(out_channels=32, num_outs=5, start_level=1,
                 add_extra_convs=True)
    v, mod = init_pair(ref, FPN(chans, 32, 5, start_level=1), [feats])
    outs_ref = ref.apply(v, feats)
    with torch.no_grad():
        outs = mod([nchw(f) for f in feats])
    assert len(outs) == len(outs_ref) == 5
    for o, r in zip(outs, outs_ref):
        assert_close_nhwc(o, r)
