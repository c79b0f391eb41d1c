"""The port's data-parallel training step against the JAX package's
steps, on the CPU.

tests/test_torch_train.py's narrow R-18 (widths 32, 128^2, f32, max_pos
64) and its seeded batch of 2 images, two SGD steps from the same
weights: the port's step on two gloo processes of one image each
(tests/test_torch_parallel_child.py) against the JAX step jitted over a
2-device mesh (parallel/train.make_train_step(mesh=...): SPMD over the
global batch) and against the one-device JAX step, which the mesh step
computes.  On this batch the mesh step's second step departs from the
one-device step's by up to 0.24 of a tensor's update (loss_rbox_refine
0.6048549 against 0.6096017): after the first step the two differ at
f32 rounding (0.0019 of an update, as the port does from either), and a
refine candidate near a tie goes the other way.  So the port is held to
the mesh step for the first step and to the one-device step for both.
Also: compute_losses without a group is unchanged by the reduce
argument, and with one its counts become the global batch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_parallel_child as child
from orientedreppoints_tpu.core.loss_head import LossConfig as LossConfigRef
from orientedreppoints_tpu.parallel import train as train_ref
from orientedreppoints_tpu_torch.apis import build_loss_config
from orientedreppoints_tpu_torch.core.loss_head import compute_losses
from orientedreppoints_tpu_torch.parallel import train
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_torch_train import (assert_same_step, jax_fast_compile,  # noqa: F401
                              jax_steps, jax_trainer, port_model, setup)

STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_mesh_steps(setup, n_steps):  # noqa: F811
    """n SGD steps of the JAX step over a 2-device 'data' mesh."""
    variables = setup["variables"]
    tx = train_ref.build_optimizer(
        variables["params"], train_ref.lr_schedule(iters_per_epoch=10),
        frozen_prefixes=train_ref.default_frozen_prefixes(1))
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    step_fn = train_ref.make_train_step(
        setup["model_ref"], LossConfigRef(max_pos=64), mesh=mesh,
        img_norm=setup["img_norm"])
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = train_ref.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.array,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx)
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    out = []
    for _ in range(n_steps):
        with jax_fast_compile():
            state, losses = step_fn(state, batch)
        out.append(({k: float(v) for k, v in losses.items()},
                    flax_to_torch({"params": jax.tree_util.tree_map(
                        np.asarray, state.params),
                        "batch_stats": variables["batch_stats"]})))
    return out


@pytest.fixture(scope="module")
def runs(setup, jax_trainer, tmp_path_factory):  # noqa: F811
    """(the JAX mesh steps, the JAX one-device steps, the port's ranks)."""
    spec = dict(cfg=setup["cfg"], state_dict=flax_to_torch(
        setup["variables"]), batch=setup["batch"], steps=STEPS,
        recipe="sgd", seed=0)
    ranks = child.launch(spec, 2, tmp_path_factory.mktemp("ddp"))
    return (jax_mesh_steps(setup, STEPS),
            jax_steps(setup, jax_trainer, STEPS, setup["batch"]), ranks)


def assert_losses_match(ref_losses, ranks, step):
    """Each loss and count of the group (the ranks' sums) within rel 1e-5
    of ref's: the counts equal, the losses the two frameworks' f32
    rounding apart; every rank returns the same."""
    assert ref_losses["num_pos"] > 0
    for rank in ranks:
        losses = rank["records"][step]["losses"]
        assert set(losses) == set(ref_losses)
        for k, v in ref_losses.items():
            np.testing.assert_allclose(losses[k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_ddp_first_step_matches_the_jax_mesh_step(setup, runs):  # noqa: F811
    """The first step's losses within rel 1e-5 of the mesh step's, and the
    parameters after it within test_torch_train's tolerance (3e-2 of
    each tensor's update), the frozen stages untouched bit for bit."""
    mesh, _, ranks = runs
    assert_losses_match(mesh[0][0], ranks, 0)
    first = ranks[0]["records"][0]
    assert_same_step(setup, mesh[0], (first["losses"], first["state_dict"]))


@pytest.mark.parametrize("step", range(STEPS), ids=["one_step", "two_steps"])
def test_ddp_steps_match_the_jax_one_device_step(setup, runs,  # noqa: F811
                                                 step):
    """Both steps' losses within rel 1e-5 of the one-device JAX step's of
    the global batch; after two steps every rank holds the same
    parameters, within test_torch_train's tolerance of JAX's."""
    _, single, ranks = runs
    assert_losses_match(single[step][0], ranks, step)
    assert [r["rows"] for r in ranks] == [[1] * STEPS] * 2
    if step == STEPS - 1:
        last = [r["records"][step] for r in ranks]
        assert all(torch.equal(last[0]["state_dict"][k], v)
                   for k, v in last[1]["state_dict"].items())
        assert_same_step(setup, single[step], (last[0]["losses"],
                                               last[0]["state_dict"]))


def test_ddp_stats_are_the_global_batchs(setup, runs):  # noqa: F811
    """The step's per-image stats come back gathered in rank order: the
    one-process step's refine assignment of the same weights and batch."""
    ranks = runs[2]
    one = child.run_steps(dict(cfg=setup["cfg"], state_dict=flax_to_torch(
        setup["variables"]), batch=setup["batch"], steps=1, recipe="sgd",
        seed=0), None)
    want = one["records"][0]["stats"]
    for rank in ranks:
        got = rank["records"][0]["stats"]
        assert torch.equal(got["gt_inds"], want["gt_inds"])
        torch.testing.assert_close(got["iou_gt_0p1"], want["iou_gt_0p1"],
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def head(setup):  # noqa: F811
    model = port_model(setup).train()
    norm = setup["img_norm"]
    batch = train.to_device(setup["batch"], "cpu")
    with torch.no_grad():
        outs = model(train.device_normalize(batch["images"], batch["img_hw"],
                                            **norm))
    return outs, batch


def test_compute_losses_reduce_identity_is_bit_identical(setup,  # noqa: F811
                                                        head):
    """reduce=identity (a group of one) gives the losses of reduce=None
    bit for bit."""
    outs, batch = head
    cfg = build_loss_config(setup["cfg"])
    args = (outs, batch["gt_polys"], batch["gt_labels"], batch["gt_valid"],
            batch["img_hw"], cfg)
    a = compute_losses(*args)
    b = compute_losses(*args, reduce=lambda t: t)
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_compute_losses_divides_by_the_global_counts(setup,  # noqa: F811
                                                     head):
    """Each image's losses over the batch's counts (a reduce that adds the
    other image's counts) sum to the batch's losses: the arithmetic each
    rank does."""
    outs, batch = head
    cfg = build_loss_config(setup["cfg"])
    cols = ("gt_polys", "gt_labels", "gt_valid", "img_hw")
    whole = compute_losses(outs, *(batch[k] for k in cols), cfg)

    def rows(i):
        return ({k: [t[i:i + 1] for t in v] for k, v in outs.items()},
                [batch[k][i:i + 1] for k in cols])

    counts = []  # every count each image's loss reduces, in call order
    for i in (0, 1):
        o, b = rows(i)
        compute_losses(o, *b, cfg, reduce=lambda t: counts.append(
            t.clone()) or t)
    n = len(counts) // 2
    parts = []
    for i in (0, 1):
        o, b = rows(i)
        others = iter(counts[(1 - i) * n:(2 - i) * n])
        parts.append(compute_losses(o, *b, cfg,
                                    reduce=lambda t: t + next(others)))
    for k, v in whole.items():
        torch.testing.assert_close(parts[0][k] + parts[1][k], v, rtol=1e-5,
                                   atol=1e-7, msg=k)
