"""The data-parallel loader, checkpoints and training CLI, on the CPU.

The loader on two gloo ranks (tests/test_torch_parallel_child.py's
SizedDataset: images of many sizes over three canvas buckets): the ranks'
batches stacked are the one-process batches when the pipeline draws
nothing, a random pipeline draws from RandomState([seed, epoch, rank]),
a global batch a rank's share drops out of is skipped on both, and a
global batch two ranks do not split is refused.  Checkpoints: rank 0
alone writes, every rank meets at the barrier.  tools/train_torch.py
through the launcher's env contract on two gloo ranks (test_torch_
checkpoint's narrow R-18 config and tiles): 2 iterations with --validate,
one checkpoint, then --resume_from at W = 2 through
tools/dist_train_torch.sh goes on to iteration 3; and
tools/dryrun_ddp_torch.py 2.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_parallel_child as child
from orientedreppoints_tpu_torch.data.loader import (GroupedBatchSampler,
                                                     aug_rng, pick_canvas)
from orientedreppoints_tpu_torch.parallel import dist
from orientedreppoints_tpu_torch.utils import checkpoint
from test_torch_checkpoint import REPO, data  # noqa: F401
from tools.launch_torch import launch_local

CASES = dict(plain={}, random=dict(random=True), dropped=dict(empty=(2, 5)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return child.launch(dict(loader_cases=CASES), 2,
                        tmp_path_factory.mktemp("loader"))


def test_ranks_stack_to_the_one_process_batches(ranks):
    """No random step: per global batch, rank 0's rows then rank 1's are
    the one-process batch, canvas and all, over two epochs; in some
    batches a rank's own rows alone would take a smaller bucket."""
    want = child.load_epochs(CASES["plain"], None)
    grown = 0
    for epoch, batches in enumerate(want):
        got = [r["plain"][epoch] for r in ranks]
        assert len(got[0]) == len(got[1]) == len(batches) == 5
        for j, b in enumerate(batches):
            for k, v in b.items():
                stacked = np.concatenate([got[0][j][k], got[1][j][k]])
                assert stacked.dtype == v.dtype, k
                np.testing.assert_array_equal(stacked, v, err_msg=k)
            for r in range(2):
                own = pick_canvas(*got[r][j]["img_hw"].max(0),
                                  child.LOADER["canvas_buckets"])
                grown += own != b["images"].shape[1:3]
    assert grown > 0


def test_random_pipeline_draws_per_rank(ranks):
    """A random pipeline: rank r prepares its rows of each global batch,
    in the sampler's order, from aug_rng(seed, epoch, r), and both ranks
    put them on the canvas of the global batch's largest image."""
    ds = child.SizedDataset(random=True)
    kw = child.LOADER
    b = kw["batch_size"] // 2
    for epoch in range(2):
        rngs = [aug_rng(kw["seed"], epoch, r) for r in range(2)]
        sampler = GroupedBatchSampler(ds.flag, kw["batch_size"],
                                      seed=kw["seed"] + epoch)
        for j, idx in enumerate(sampler):
            rows = [[ds.prepare(int(i), rngs[r])
                     for i in idx[r * b:(r + 1) * b]] for r in range(2)]
            hw = [max(s["img"].shape[d] for rr in rows for s in rr)
                  for d in (0, 1)]
            canvas = pick_canvas(*hw, kw["canvas_buckets"])
            for r in range(2):
                got = ranks[r]["random"][epoch][j]
                assert got["images"].shape[1:3] == canvas
                for i, s in enumerate(rows[r]):
                    img = s["img"][:canvas[0], :canvas[1]]  # collate crops
                    h, w = img.shape[:2]
                    np.testing.assert_array_equal(got["images"][i, :h, :w],
                                                  img)
                    assert tuple(got["img_hw"][i]) == s["img"].shape[:2]


def test_a_global_batch_without_rows_on_a_rank_is_skipped(ranks):
    """Items 2 and 5 prepare to None: a global batch with no row left on a
    rank is skipped on both ranks; the others keep their rows."""
    for epoch in range(2):
        got = [r["dropped"][epoch] for r in ranks]
        assert len(got[0]) == len(got[1]) >= 2
        for a, b in zip(*got):
            assert len(a["images"]) and len(b["images"])
            assert a["images"].shape[1:] == b["images"].shape[1:]
            labels = np.concatenate([a["gt_polys"][:, 0, 0],
                                     b["gt_polys"][:, 0, 0]])
            assert not set(labels.tolist()) & {2.0, 5.0}


def test_a_batch_the_ranks_do_not_split_is_refused(ranks):
    assert all(r.get("refuses_batch_3") for r in ranks)


def test_rank_zero_alone_writes_the_checkpoint(tmp_path, monkeypatch):
    """save_checkpoint under a group: rank 0 writes the file, rank 1 does
    not, and both wait at the barrier after it."""
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    calls = []
    monkeypatch.setattr(dist, "barrier", lambda g: calls.append(g))
    group = object()
    for rank in (1, 0):
        monkeypatch.setattr(dist, "rank", lambda g, r=rank: r)
        d = tmp_path / f"rank{rank}"
        path = checkpoint.save_checkpoint(str(d), 1, model, opt, sched, 7,
                                          group=group)
        assert path == str(d / "epoch_1.pt")
        assert os.path.exists(path) == (rank == 0)
    assert calls == [group, group]
    assert checkpoint._read(str(tmp_path / "rank0"))["step"] == 7


def rank_lines(out: str, marker: str) -> list:
    return [line for line in out.splitlines() if marker in line]


def test_train_cli_data_parallel_and_resume(data, tmp_path):  # noqa: F811
    """tools/train_torch.py on two gloo ranks through the ORP_* contract
    (tools/launch_torch.launch_local): the config's global batch of 8 split
    4 + 4, two iterations logged by rank 0 alone (the group's losses), its
    validation, one checkpoint; then tools/dist_train_torch.sh (NPROC=2)
    starts both ranks again, which resume from it and go on to iteration
    3."""
    root, _ = data
    args = [sys.executable, "tools/train_torch.py", str(root / "narrow.py"),
            "--work_dir", str(tmp_path), "--device", "cpu",
            "--log_interval", "1"]
    env = dict(os.environ, PYTHONPATH=REPO)
    first = launch_local(args + ["--max_iters", "2", "--validate",
                                 "--val_max_images", "2"], 2, env=env,
                         timeout=600, cwd=REPO)
    assert rank_lines(first[0], "data-parallel: 2 processes, gloo backend")
    assert len(rank_lines(first[0], "epoch 0 iter ")) == 2
    assert rank_lines(first[0], "epoch 0 val mAP")
    assert not first[1].strip()  # rank 1 logs nothing at INFO
    assert os.listdir(tmp_path / "ckpts") == ["epoch_1.pt"]
    saved = checkpoint._read(str(tmp_path / "ckpts"))
    assert saved["step"] == 2 and saved["meta"]["epoch"] == 1
    # the resumed run through the launcher itself, two processes
    res = subprocess.run(
        ["bash", "tools/dist_train_torch.sh", *args[2:], "--max_iters", "3",
         "--resume_from", str(tmp_path / "ckpts")], cwd=REPO,
        env=dict(env, NPROC="2"), capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    second = res.stdout
    assert rank_lines(second, "data-parallel: 2 processes, gloo backend")
    assert rank_lines(second, "resumed from")
    line = rank_lines(second, "epoch 1 iter 2 ")
    assert len(line) == 1 and np.isfinite(json.loads(
        line[0].split("epoch 1 iter 2 ")[1])["loss_total"])
    assert rank_lines(second, "training finished at iter 3")
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["epoch_1.pt",
                                                      "epoch_2.pt"]


def test_dryrun_ddp_tool():
    """tools/dryrun_ddp_torch.py 2: two gloo ranks of the R-18 / 3-level /
    256^2 step at one image each; their summed loss equals the
    one-process loss of the two images within 2e-5."""
    res = subprocess.run([sys.executable, "tools/dryrun_ddp_torch.py", "2"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=REPO,
                                               OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "dryrun_ddp_torch(2): R-18@256 1 image a rank" in res.stdout
    assert res.stdout.strip().endswith("OK")
