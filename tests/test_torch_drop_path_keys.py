"""The port's DropPath masks against jax.random and flax, on the CPU.

utils/jax_random.py (threefry, key, fold_in, bits, uniform, bernoulli,
flax's static fold) equals jax.random bit for bit.  For a narrow Swin
detector (tests/test_torch_swin.py's widths, DropPath 0.5 so that every
block drops often) in train mode, flax's masks are recorded where the JAX
Swin draws them (jax.random.bernoulli wrapped, a callback of its key and
mask in call order) under the JAX step's key fold_in(key(seed), step),
and the port's SwinTransformer.drop_masks under dropout_key(seed, step)
must give each block's masks exactly, also as rows [2, 4) of a global
batch of 4 (a rank of two, BatchRows).  The port's train-mode forward on
the same weights and key then matches JAX's within test_torch_swin's
detector tolerance (2e-4 of each output's largest element).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu_torch.models import swin
from orientedreppoints_tpu_torch.parallel.train import dropout_key
from orientedreppoints_tpu_torch.utils import jax_random as jr
from test_torch_models import numpy_tree
from test_torch_slice import perturb_head
from test_torch_swin import fast_jit, jax_detector, port_detector, tiny_cfg

RATE = 0.5
SIZE = 64
BATCH = 4
PAIRS = ((0, 0), (0, 5), (7, 1), (12345, 250))  # (seed, step)
DRAWS = 14  # two a block of the 7 (of 8) whose rate is above 0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jkey(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1, 2 ** 32 + 3,
                                  -5])
def test_key_and_fold_in_match_jax(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(jr.key(seed), jkey(k))
    for data in (0, 1, 77, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(jr.fold_in(jr.key(seed), data),
                                      jkey(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("shape", [(1,), (5,), (4, 1, 1, 1), (3, 7, 2)])
def test_bits_and_uniform_match_jax(shape):
    k = jax.random.fold_in(jax.random.key(3), 9)
    ours = jr.fold_in(jr.key(3), 9)
    np.testing.assert_array_equal(jr.random_bits(ours, shape),
                                  np.asarray(jax.random.bits(k, shape)))
    got = jr.uniform(ours, shape)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got.view(np.uint32),
        np.asarray(jax.random.uniform(k, shape)).view(np.uint32))


@pytest.mark.parametrize("p", [0.5, 1.0 - 0.2 / 11, 1.0 - 0.2 * 5 / 11,
                               0.9, 1e-3])
def test_bernoulli_matches_jax(p):
    """p is compared as float32: 1 - rate for rates of np.linspace."""
    keys = [jax.random.fold_in(jax.random.key(11), i) for i in range(40)]
    want = np.stack([np.asarray(jax.random.bernoulli(k, p, (64,)))
                     for k in keys])
    got = jr.bernoulli(np.stack([jkey(k) for k in keys]), p, (64,))
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_static_fold_matches_flax():
    """flax's _fold_in_static: names and counts (1 -> b'\\x01', 256 ->
    two bytes) hashed into one fold_in."""
    from flax.core import scope

    assert not flax.config.flax_fix_rng_separator
    k = jax.random.key(5)
    for path in [("backbone", "stage0_block1", 1), ("stage3_block1", 2),
                 ("a", 256), ()]:
        want = jkey(scope._fold_in_static(k, path))
        np.testing.assert_array_equal(jr.fold_static(jr.key(5), path), want)


@pytest.fixture(scope="module")
def flax_draws():
    """The JAX detector in train mode on a seeded batch, jitted once with
    the step's key as an argument: per (seed, step) its outputs and every
    (key, mask) that jax.random.bernoulli gave, in call order."""
    model = jax_detector(drop_path_rate=RATE)
    x = np.random.default_rng(2).normal(
        size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    variables = perturb_head(numpy_tree(fast_jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))),
        np.random.default_rng(0))
    calls = []
    real = jax.random.bernoulli

    def recorded(key, p, shape):
        mask = real(key, p, shape)
        jax.debug.callback(
            lambda k, m: calls.append((np.asarray(k), np.asarray(m))),
            jax.random.key_data(key), mask, ordered=True)
        return mask

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "bernoulli", recorded)
    try:
        apply = fast_jit(lambda v, imgs, rng: model.apply(
            v, imgs, deterministic=False, rngs={"dropout": rng}))
        runs = {}
        for seed, step in PAIRS:
            calls.clear()
            rng = jax.random.fold_in(jax.random.key(seed), step)
            outs = jax.tree_util.tree_map(np.asarray, apply(variables, x,
                                                            rng))
            runs[seed, step] = (outs, list(calls))
    finally:
        mp.undo()
    return dict(x=x, variables=variables, runs=runs)


@pytest.fixture(scope="module")
def port(flax_draws):
    return port_detector(flax_draws["variables"], tiny_cfg(RATE))


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{s}_{t}" for s, t in PAIRS])
def test_block_masks_are_flax(flax_draws, port, pair):
    """Each block's two masks (after the attention, after the MLP) under
    dropout_key(seed, step) are flax's, and so is each draw's key."""
    _, calls = flax_draws["runs"][pair]
    assert len(calls) == DRAWS == 2 * len(port.backbone.drawing)
    key = dropout_key(*pair)
    got = port.backbone.drop_masks(key, BATCH)
    want = np.stack([m.reshape(-1) for _, m in calls])
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    paths = [("backbone", n, c) for n in port.backbone.drawing
             for c in (1, 2)]
    for path, (k, _) in zip(paths, calls):
        np.testing.assert_array_equal(jr.fold_static(key, path), k)


def test_batch_rows_masks_are_flax(flax_draws, port):
    """A rank of two holding rows [2, 4) of the global batch of 4 draws
    the global batch's masks and keeps its rows: flax's columns 2-3."""
    for pair in PAIRS[:2]:
        _, calls = flax_draws["runs"][pair]
        want = np.stack([m.reshape(-1) for _, m in calls])[:, 2:4]
        got = port.backbone.drop_masks(
            swin.BatchRows(dropout_key(*pair), 2, BATCH), 2)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pair", PAIRS[1:3],
                         ids=[f"{s}_{t}" for s, t in PAIRS[1:3]])
def test_train_forward_matches_jax(flax_draws, port, pair):
    """The train-mode forward under the same key: every level of every
    head output within 2e-4 of its largest element (f32)."""
    outs_ref, _ = flax_draws["runs"][pair]
    port.train()
    try:
        with torch.no_grad():
            outs = port(torch.from_numpy(flax_draws["x"]),
                        dropout_key(*pair))
    finally:
        port.eval()
    for name in ("cls_scores", "pts_init", "pts_refine"):
        for got, want in zip(outs[name], outs_ref[name]):
            got = got.numpy() if got.shape == want.shape else \
                got.permute(0, 2, 3, 1).numpy()
            err = np.abs(got - want).max()
            assert err <= 2e-4 * max(1.0, np.abs(want).max()), (name, err)
