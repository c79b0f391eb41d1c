"""The order of the DCN backward's table-grad sums (ops/deform_conv.py,
csrc/deform_sample_bwd.cu) and the deterministic training step.

The backward kernel sums each table-grad value from +0.0, one term after
another, in the plain version's order: corner 0..3, then sample (row * K
+ tap) ascending.  These tests pin that order on the CPU: the plain
version's index_add_ scatter equals a sequential numpy oracle (np.add.at)
bit for bit, and so does a numpy mirror of the kernel's algorithm
(entries keyed corner * S + sample, a counting sort by destination row,
each row's keys sorted, ordered sums).  Then a step built by
parallel/train.make_train_step runs under utils/determinism.deterministic.
"""

import os

import numpy as np
import pytest
import torch

from orientedreppoints_tpu_torch.ops import deform_conv
from orientedreppoints_tpu_torch.parallel import train
from orientedreppoints_tpu_torch.utils import determinism

SHAPES = [(2, 9, 11), (2, 5, 6), (2, 3, 3)]  # a 3-level pyramid
K = 9


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, c, n_tables, dtype, pile):
    """Tables, offsets and f32 sample grads on SHAPES.  pile: every
    sample's offsets send it near one of a few pixels of its level, so
    hundreds of corners land on each of them; otherwise offsets of std 2
    px, a tenth thrown off the map.  Some grads are -0.0 and some exactly
    0."""
    rng = np.random.default_rng(seed)
    rows = sum(b * h * w for b, h, w in SHAPES)
    tables = [torch.from_numpy(rng.normal(size=(rows, c)).astype(
        np.float32)).to(dtype) for _ in range(n_tables)]
    base = deform_conv.dcn_base_offset(3).numpy().reshape(K, 2)
    offs = []
    for b, h, w in SHAPES:
        yx = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                  indexing="ij"), -1).reshape(1, h * w, 1, 2)
        if pile:  # the targets (1, 1), (1, w - 2), (h - 2, 1) and a fraction
            targets = np.array([[1, 1], [1, w - 2], [h - 2, 1]], np.float32)
            pick = rng.integers(0, 3, (b, h * w, K))
            target = targets[pick] + rng.uniform(0, 1, (b, h * w, K, 2))
            off = target - yx - base
        else:
            off = rng.normal(0, 2, (b, h * w, K, 2))
            far = rng.random((b, h * w, K)) < 0.1
            off[far] = 40.0
        offs.append(off.reshape(-1, 2 * K))
    offsets = torch.from_numpy(np.concatenate(offs).astype(np.float32)).to(
        dtype)
    grads = []
    for _ in range(n_tables):
        g = rng.normal(size=(rows, K * c)).astype(np.float32)
        pick = rng.random(g.shape)
        g[pick < 0.05] = -0.0
        g[(pick >= 0.05) & (pick < 0.1)] = 0.0
        grads.append(torch.from_numpy(g))
    return tables, offsets, grads


def entries(tables, offsets, grads, c):
    """The plan's entries: for each corner, the destination rows, the f32
    weight (zero off the map), and each table's grads rounded to its
    dtype, as f32 numpy arrays."""
    idx, ok, wy, wx = deform_conv.pyramid_plan(SHAPES, offsets, 3)
    weights = ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)
    w = [(cw * o.to(torch.float32)).numpy() for cw, o in zip(weights, ok)]
    rounded = [g.reshape(-1, c).to(t.dtype).to(torch.float32).numpy()
               for g, t in zip(grads, tables)]
    return [i.numpy() for i in idx], w, rounded


def oracle(tables, offsets, grads, c):
    """The table grads as np.add.at sums them: each corner in turn, its
    samples in ascending order, one after another (f32)."""
    idx, w, rounded = entries(tables, offsets, grads, c)
    rows = tables[0].shape[0]
    out = []
    for r in rounded:
        acc = np.zeros((rows, c), np.float32)
        for i, cw in zip(idx, w):
            np.add.at(acc, i, r * cw[:, None])
        out.append(acc)
    return out


def kernel_mirror(tables, offsets, grads, c, seed):
    """The kernel's algorithm in numpy: the entries that add anything (on
    the map, weight not 0) keyed corner * S + sample; counted by
    destination row, placed into each row's segment in a shuffled order
    (the kernel's integer atomics pick the slots), each segment sorted by
    key, then summed from +0.0 in that order (f32)."""
    idx, w, rounded = entries(tables, offsets, grads, c)
    rows, s_count = tables[0].shape[0], idx[0].shape[0]
    keys = np.concatenate([k * s_count + np.flatnonzero(cw != 0)
                           for k, cw in enumerate(w)])
    dest = np.concatenate([i[cw != 0] for i, cw in zip(idx, w)])
    counts = np.bincount(dest, minlength=rows)
    seg = np.concatenate([[0], np.cumsum(counts)])
    slots = np.empty_like(keys)
    fill = seg[:-1].copy()
    for e in np.random.default_rng(seed).permutation(len(keys)):
        slots[fill[dest[e]]] = keys[e]
        fill[dest[e]] += 1
    for d in range(rows):
        slots[seg[d]:seg[d + 1]].sort()
    corner, sample = slots // s_count, slots % s_count
    weight = np.stack(w)[corner, sample]
    out = []
    for r in rounded:
        acc = np.zeros((rows, c), np.float32)
        for j in range(counts.max()):  # the j-th term of every longer row
            rows_j = np.flatnonzero(counts > j)
            at = seg[rows_j] + j
            acc[rows_j] += r[sample[at]] * weight[at][:, None]
        out.append(acc)
    return out, counts.max()


def plain(tables, offsets, grads):
    if len(tables) == 2:
        return deform_conv.deform_sample_pair_backward_plain(
            *tables, offsets, *grads, SHAPES)
    return deform_conv.deform_sample_backward_plain(*tables, offsets, *grads,
                                                    SHAPES)


def bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()]).numpy()


CASES = pytest.mark.parametrize(
    "c, n_tables, dtype, pile",
    [(20, 2, torch.float32, False), (48, 2, torch.bfloat16, False),
     (20, 1, torch.bfloat16, True), (48, 1, torch.float32, True),
     (20, 2, torch.bfloat16, True), (48, 2, torch.float32, True)],
    ids=["c20_pair_f32", "c48_pair_bf16", "c20_single_bf16_pile",
         "c48_single_f32_pile", "c20_pair_bf16_pile", "c48_pair_f32_pile"])


@CASES
def test_plain_table_grads_sum_in_the_declared_order(c, n_tables, dtype,
                                                     pile):
    """The plain version's table grads equal the sequential np.add.at
    oracle bit for bit (rounded to the table dtype as the plain version
    rounds them), -0.0 grads and zero weights included."""
    tables, offsets, grads = inputs(c + n_tables, c, n_tables, dtype, pile)
    got = plain(tables, offsets, grads)[:n_tables]
    want = oracle(tables, offsets, grads, c)
    for g, wnt in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_array_equal(bits(g),
                                      bits(torch.from_numpy(wnt).to(dtype)))


@CASES
def test_kernel_algorithm_mirror_equals_the_plain_version(c, n_tables, dtype,
                                                          pile):
    """The kernel's algorithm (entries, counting sort, sorted segments,
    ordered sums) in numpy gives the plain version's f32 sums bit for bit
    whatever order the entries were placed in; the piled offsets put
    hundreds of terms on a row (the kernel's sorted long segments)."""
    tables, offsets, grads = inputs(c + n_tables, c, n_tables, dtype, pile)
    want = oracle(tables, offsets, grads, c)
    for seed in (0, 1):
        got, longest = kernel_mirror(tables, offsets, grads, c, seed)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.view(np.int32),
                                          wnt.view(np.int32))
    assert longest > (200 if pile else 4)
    rounded = plain(tables, offsets, grads)[:n_tables]
    for g, r in zip(got, rounded):
        np.testing.assert_array_equal(bits(torch.from_numpy(g).to(dtype)),
                                      bits(r))


def test_bwd_workspace_matches_the_kernel_layout():
    """The wrapper's workspace size follows csrc/deform_sample_bwd.cu's
    work_layout: counts and segment starts a row, a sum a scan chunk of
    4,096, then 16-byte-aligned keys and weights for 4 corners a sample."""
    rows, k = 75212, 9
    seg = 4 * rows
    bsum = -(-(seg + 4 * (rows + 1)) // 16) * 16
    keys = -(-(bsum + 4 * 19) // 16) * 16
    assert deform_conv._bwd_work_bytes(rows, k) == keys + 8 * 4 * rows * k
    assert deform_conv._bwd_work_bytes(1, 1) == 80


class _Probe(torch.nn.Module):
    """A model that records the deterministic settings in force when the
    step calls it, then stops the step."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.seen = None

    def forward(self, imgs, key=None):
        self.seen = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark,
                     torch.utils.deterministic.fill_uninitialized_memory)
        raise StopIteration


def test_the_train_step_runs_under_the_determinism_helper(monkeypatch):
    """A step built by make_train_step runs under deterministic(): PyTorch's
    deterministic algorithms (raising, not warning), cuDNN deterministic
    without benchmark, no fill of uninitialised memory, the cuBLAS
    workspace set; the caller's settings come back after the step."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    model = _Probe()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: 1.0)
    step = train.make_train_step(model, None, opt, sched)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    batch = {k: torch.zeros((1, 4, 4, 3)) for k in train.BATCH_KEYS}
    with pytest.raises(StopIteration):
        step(batch)
    assert model.seen == (True, False, True, False, False)
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == \
        determinism.CUBLAS_WORKSPACE
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == before
    assert torch.utils.deterministic.fill_uninitialized_memory
