"""The port's data-parallel step with Swin's DropPath, on the CPU: two
gloo processes of one image each against one process stepping both.

tests/test_torch_swin.py's narrow Swin (embed 32, depths 2-2-2-2) with its
JAX initial weights (through flax_to_torch) and seeded batch, DropPath
0.5, two SGD steps (test_torch_train's recipe: AdamW would step the grads
at rounding noise, the out-norms' biases here, at full size, and hide
the comparison in that noise).  Each rank draws the global batch's masks
under dropout_key(seed, step) and keeps its rows (models/swin.
BatchRows), so the ranks' masks stacked are the one-process masks; the
grads the ranks reduce equal the one-process grads at f32 rounding.
The same on the data-parallel loader's uneven shares (2 + 1 rows of a
global batch of 4 one of whose rows drops out), against one process
loading the same 3 rows.
"""

import numpy as np
import pytest
import torch

import test_torch_parallel_child as child
from orientedreppoints_tpu_torch.data.loader import GroupedBatchSampler
from orientedreppoints_tpu_torch.models import swin
from orientedreppoints_tpu_torch.parallel import train
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_torch_swin import tiny_cfg, train_setup  # noqa: F401
from test_torch_train import make_batch

STEPS = 2
RATE = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(train_setup, tmp_path_factory):  # noqa: F811
    spec = dict(cfg=tiny_cfg(RATE), state_dict=flax_to_torch(
        train_setup["variables"]), batch=train_setup["batch"], steps=STEPS,
        recipe="sgd", seed=0)
    return (spec, child.run_steps(spec, None),
            child.launch(spec, 2, tmp_path_factory.mktemp("ddp_swin")))


def test_ranks_draw_the_one_process_masks(runs):
    """assert_same_masks on the even split, a row a rank."""
    _, one, ranks = runs
    assert_same_masks(one, ranks)


def assert_same_step(spec, one, ranks, step):
    """The group's losses within rel 1e-5 of the one-process step's (the
    counts equal), the same refine assignment, the reduced, clipped grads
    within 1e-6 of the largest grad (measured 2e-7), and the parameters
    after the step: every tensor whose grad reaches 1e-6 of the largest
    within 1e-2 of its update's norm (measured 6.5e-4), the whole update
    as one vector within 1e-4 of its norm (measured 2.7e-6); the out
    norms' biases, whose grads are rounding noise (~1e-10 of the
    largest: the lateral conv's GN removes a channel's constant), only as
    part of the vector.  Both ranks hold the same parameters."""
    want = one["records"][step]
    start = spec["state_dict"]
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    for rank in ranks:
        got = rank["records"][step]
        for k, v in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert torch.equal(got["stats"]["gt_inds"], want["stats"]["gt_inds"])
        for k, g in want["grads"].items():
            err = float((got["grads"][k] - g).abs().max())
            assert err <= 1e-6 * gmax, (k, err / gmax)
    sds = [r["records"][step]["state_dict"] for r in ranks]
    assert all(torch.equal(sds[0][k], v) for k, v in sds[1].items())
    diff2 = norm2 = 0.0
    for k, g in want["grads"].items():
        moved = want["state_dict"][k] - start[k]
        d = float((sds[0][k] - want["state_dict"][k]).norm())
        n = float(moved.norm())
        if float(g.abs().max()) >= 1e-6 * gmax:
            assert d <= 1e-2 * n, (k, d / n)
        diff2, norm2 = diff2 + d * d, norm2 + n * n
    assert norm2 > 0 and diff2 ** 0.5 <= 1e-4 * norm2 ** 0.5


def assert_same_masks(one, ranks):
    """Every DropPath call: rank 0's rows then rank 1's are the one
    process's mask, and the masks drop something."""
    assert len(one["drops"]) == len(ranks[0]["drops"]) == len(
        ranks[1]["drops"]) > 0
    for whole, a, b in zip(one["drops"], ranks[0]["drops"],
                           ranks[1]["drops"]):
        assert torch.equal(torch.cat([a, b]), whole)
    share = float(torch.cat(one["drops"]).float().mean())
    assert 0 < share < 1


@pytest.mark.parametrize("step", range(STEPS), ids=["one_step", "two_steps"])
def test_w2_step_equals_the_w1_step(runs, step):
    """assert_same_step on the even split, a row a rank."""
    spec, one, ranks = runs
    assert_same_step(spec, one, ranks, step)


@pytest.fixture(scope="module")
def uneven(train_setup, tmp_path_factory):  # noqa: F811
    """The data-parallel loader over 4 rows (train_setup's batch and
    make_batch(RandomState(1))'s) with one row that prepares to None, a
    global batch of 4 an epoch: the ranks hold 2 and 1 rows of each
    epoch's 3; one process loads the 3 rows.  STEPS epochs, a step each."""
    extra = make_batch(np.random.RandomState(1))
    batch = {k: np.concatenate([v, extra[k]])
             for k, v in train_setup["batch"].items()}
    loader = dict(batch_size=4, seed=5)
    first = next(iter(GroupedBatchSampler(np.zeros(4, np.uint8), 4,
                                          seed=loader["seed"])))
    loader["empty"] = [int(first[3])]  # rank 1's share in epoch 0
    spec = dict(cfg=tiny_cfg(RATE), state_dict=flax_to_torch(
        train_setup["variables"]), batch=batch, steps=STEPS, recipe="sgd",
        seed=0, loader=loader)
    return (spec, child.run_steps(spec, None),
            child.launch(spec, 2, tmp_path_factory.mktemp("ddp_uneven")))


def test_uneven_shares_draw_the_one_process_masks(uneven):
    """The loader's uneven shares (2 + 1 rows in epoch 0) stack to the
    one-process batch of 3, and DropPath keeps each rank's rows of the
    one-process masks."""
    _, one, ranks = uneven
    assert one["rows"] == [3] * STEPS
    assert ranks[0]["rows"][0] == 2 and ranks[1]["rows"][0] == 1
    assert all(a + b == 3 for a, b in zip(ranks[0]["rows"],
                                          ranks[1]["rows"]))
    assert_same_masks(one, ranks)


@pytest.mark.parametrize("step", range(STEPS), ids=["one_step", "two_steps"])
def test_uneven_w2_step_equals_the_w1_step(uneven, step):
    """assert_same_step on the loader's uneven shares: the step exchanges
    the ranks' row counts, so the gathered stats and DropPath's rows are
    the one-process step's."""
    spec, one, ranks = uneven
    assert_same_step(spec, one, ranks, step)


def test_batch_rows_draw_the_global_mask():
    """drop_masks with BatchRows: a rank's masks are its rows [offset,
    offset + b) of the masks one process draws over the whole batch under
    the same key, for even and uneven shares; over the whole batch they
    are the plain key's; rows past the batch are refused."""
    model = swin.SwinTransformer(embed_dim=8, depths=(2, 2), num_heads=(1, 1),
                                 out_indices=(1,), drop_path_rate=RATE)
    key = train.dropout_key(3, 7)
    whole = model.drop_masks(key, 6)
    assert np.array_equal(model.drop_masks(swin.BatchRows(key, 0, 6), 6),
                          whole)
    for bounds in ((0, 2, 4, 6), (0, 3, 4, 6)):
        parts = [model.drop_masks(swin.BatchRows(key, lo, 6), hi - lo)
                 for lo, hi in zip(bounds, bounds[1:])]
        assert np.array_equal(np.concatenate(parts, 1), whole)
    assert whole.shape == (6, 6) and whole.any() and not whole.all()
    with pytest.raises(ValueError, match="rows"):
        model.drop_masks(swin.BatchRows(key, 5, 6), 2)
