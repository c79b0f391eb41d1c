"""The single DCNv1 (ops/deform_conv.py::deform_conv2d and
deform_conv2d_pyramid) against the JAX package's functions of those names:
forward in f32 and bf16, and the grads of features, offsets and weight
against jax.vjp, on seeded numpy inputs (CPU: the plain versions of the
single-table sampling kernels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.ops import deform_conv as dcn_ref
from orientedreppoints_tpu_torch.ops import deform_conv

B, C, COUT = 2, 16, 8
HWS = [(8, 10), (4, 5), (2, 3), (1, 2)]  # an FPN's shrinking levels


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, hws=HWS, ks=3, spread=2.0):
    """Per-level features, offsets and output grads, and one weight."""
    rng = np.random.default_rng(seed)
    k = ks * ks
    feats = [rng.normal(size=(B, h, w, C)).astype(np.float32)
             for h, w in hws]
    offs = [(rng.normal(size=(B, h, w, 2 * k)) * spread).astype(np.float32)
            for h, w in hws]
    weight = rng.normal(size=(k, C, COUT)).astype(np.float32)
    cots = [rng.normal(size=(B, h, w, COUT)).astype(np.float32)
            for h, w in hws]
    return feats, offs, weight, cots


def as_torch(xs, dtype):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("ks, spread", [(3, 2.0), (3, 8.0), (1, 1.5)],
                         ids=["k3", "k3_far", "k1"])
def test_forward_f32_matches_jax(ks, spread):
    """deform_conv2d on each level and deform_conv2d_pyramid over all of
    them, f32, within deform_conv's oracle tolerance (rtol/atol 1e-4);
    far offsets put many corners off the map."""
    feats, offs, weight, _ = inputs(0, ks=ks, spread=spread)
    got = deform_conv.deform_conv2d_pyramid(
        as_torch(feats, torch.float32), as_torch(offs, torch.float32),
        torch.from_numpy(weight), kernel_size=ks)
    want = dcn_ref.deform_conv2d_pyramid(
        [jnp.asarray(f) for f in feats], [jnp.asarray(o) for o in offs],
        jnp.asarray(weight), kernel_size=ks)
    for g, w, f, o in zip(got, want, feats, offs):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
        one = deform_conv.deform_conv2d(
            torch.from_numpy(f), torch.from_numpy(o),
            torch.from_numpy(weight), kernel_size=ks)
        ref = dcn_ref.deform_conv2d(jnp.asarray(f), jnp.asarray(o),
                                    jnp.asarray(weight), kernel_size=ks)
        np.testing.assert_allclose(one.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_forward_bf16_matches_jax():
    """bf16 features and offsets, f32 weight: the output is bf16 in both.
    JAX lerps the corners in bf16 (weights and products rounded), the
    port in f32 with one rounding (ROADMAP Queue 3 item 3), so the outputs
    differ by a few bf16 roundings of the samples summed over K*C: within
    2e-2 of the largest output (measured 5.4e-3)."""
    feats, offs, weight, _ = inputs(1)
    got = deform_conv.deform_conv2d_pyramid(
        as_torch(feats, torch.bfloat16), as_torch(offs, torch.bfloat16),
        torch.from_numpy(weight))
    want = dcn_ref.deform_conv2d_pyramid(
        [jnp.asarray(f, jnp.bfloat16) for f in feats],
        [jnp.asarray(o, jnp.bfloat16) for o in offs], jnp.asarray(weight))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert rel_err(g, w) <= 2e-2


def test_offsets_in_another_dtype_are_refused():
    """JAX samples f32 offsets at f32 positions whatever the feature
    dtype; the kernels read the offsets in the feature dtype, so the port
    refuses f32 offsets with bf16 features instead of rounding them.
    Rounding would move the samples: offsets rounded to bf16 move JAX's
    own f32 output by far more than the f32 tolerance of 1e-4 (measured
    0.33 at the largest level)."""
    feats, offs, weight, _ = inputs(5, spread=8.0)
    bf = as_torch(feats, torch.bfloat16)
    for call in (lambda: deform_conv.deform_conv2d_pyramid(
                     bf, as_torch(offs, torch.float32),
                     torch.from_numpy(weight)),
                 lambda: deform_conv.deform_conv2d(
                     bf[0], torch.from_numpy(offs[0]),
                     torch.from_numpy(weight))):
        with pytest.raises(TypeError, match="offsets in torch.float32"):
            call()
    jf = [jnp.asarray(f) for f in feats]
    exact = dcn_ref.deform_conv2d_pyramid(
        jf, [jnp.asarray(o) for o in offs], jnp.asarray(weight))
    rounded = dcn_ref.deform_conv2d_pyramid(
        jf, [jnp.asarray(o, jnp.bfloat16).astype(jnp.float32) for o in offs],
        jnp.asarray(weight))
    assert max(float(jnp.abs(r - e).max())
               for r, e in zip(rounded, exact)) > 1e-2


@jax.jit
def jax_grads(feats, offs, weight, cots):
    return jax.vjp(dcn_ref.deform_conv2d_pyramid, feats, offs,
                   weight)[1](cots)


def port_grads(feats, offs, weight, cots, dtype):
    leaves = ([x.requires_grad_(True) for x in as_torch(feats, dtype)]
              + [x.requires_grad_(True) for x in as_torch(offs, dtype)]
              + [torch.from_numpy(weight).requires_grad_(True)])
    n = len(feats)
    outs = deform_conv.deform_conv2d_pyramid(leaves[:n], leaves[n:2 * n],
                                             leaves[-1])
    torch.autograd.backward(outs, as_torch(cots, dtype))
    return leaves


# relative to each grad's largest element.  f32: the two sum in other
# orders (features: the scatter; offsets: the sum over channels; weight:
# cols^T g), ~1e-6 (measured up to 2.1e-7).  bf16: the pair's tolerances
# (tests/test_torch_train.py::test_dcn_autograd_node_bf16_matches_jax_vjp,
# ROADMAP Queue 3 item 3): JAX scatter-adds the feature grads in bf16 and
# lerps in bf16, the port sums in f32 and rounds once (measured: features
# 7.5e-3, offsets 9.8e-3, weight 4.0e-3).
GRAD_TOL = {"float32": (1e-5, 1e-5, 1e-5), "bfloat16": (3e-2, 1e-2, 1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_jax_vjp(dtype):
    """The grads of features, offsets and weight (f32 weight, features and
    offsets in dtype) against jax.vjp of deform_conv2d_pyramid; the weight
    grad is an f32 sum returned in f32."""
    feats, offs, weight, cots = inputs(2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax_grads([jnp.asarray(f, jdt) for f in feats],
                    [jnp.asarray(o, jdt) for o in offs], jnp.asarray(weight),
                    [jnp.asarray(c, jdt) for c in cots])
    ref = jax.tree_util.tree_leaves(ref)
    leaves = port_grads(feats, offs, weight, cots, getattr(torch, dtype))
    n = len(feats)
    tf, to, tw = GRAD_TOL[dtype]
    for got, want, tol in zip(leaves, ref, [tf] * n + [to] * n + [tw]):
        assert got.grad.dtype == got.dtype
        assert rel_err(got.grad, want) <= tol


def test_pyramid_equals_one_call_a_level():
    """The pyramid's one table gives each level what deform_conv2d gives
    it alone, forward and grads (the plan is per row; only the matrix
    products' row blocking differs)."""
    feats, offs, weight, cots = inputs(3)
    leaves = port_grads(feats, offs, weight, cots, torch.float32)
    n = len(feats)
    outs = deform_conv.deform_conv2d_pyramid(
        as_torch(feats, torch.float32), as_torch(offs, torch.float32),
        torch.from_numpy(weight))
    gw = torch.zeros_like(leaves[-1].grad)
    for i, (f, o, c) in enumerate(zip(feats, offs, cots)):
        fi, oi = (torch.from_numpy(x).requires_grad_(True) for x in (f, o))
        wi = torch.from_numpy(weight).requires_grad_(True)
        out = deform_conv.deform_conv2d(fi, oi, wi)
        torch.testing.assert_close(out, outs[i], rtol=1e-6, atol=1e-6)
        out.backward(torch.from_numpy(c))
        torch.testing.assert_close(fi.grad, leaves[i].grad, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(oi.grad, leaves[n + i].grad, rtol=1e-6,
                                   atol=1e-6)
        gw += wi.grad
    torch.testing.assert_close(gw, leaves[-1].grad, rtol=1e-5, atol=1e-5)


def test_single_equals_the_pair_with_one_table():
    """The single-table plain versions are the pair's arithmetic for one
    table: the same sampled buffer and the same table and offset grads as
    the pair's a-side when the b-side's grad is 0."""
    rng = np.random.default_rng(4)
    shapes = [(B, h, w) for h, w in HWS]
    rows = sum(b * h * w for b, h, w in shapes)
    for dt in (torch.float32, torch.bfloat16):
        ta, tb = (torch.from_numpy(rng.normal(size=(rows, C)).astype(
            np.float32)).to(dt) for _ in range(2))
        off = torch.from_numpy((rng.normal(size=(rows, 18)) * 3).astype(
            np.float32)).to(dt)
        g = torch.from_numpy(rng.normal(size=(rows, 9 * C)).astype(
            np.float32))
        assert torch.equal(deform_conv.deform_sample(ta, off, shapes),
                           deform_conv.deform_sample_pair(ta, tb, off,
                                                          shapes)[0])
        gt, go = deform_conv.deform_sample_backward(ta, off, g, shapes)
        pa, _, po = deform_conv.deform_sample_pair_backward(
            ta, tb, off, g, torch.zeros_like(g), shapes)
        assert torch.equal(gt, pa) and torch.equal(go, po)
