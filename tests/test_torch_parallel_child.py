"""The ranks' side of the data-parallel tests (no test here).

    python tests/test_torch_parallel_child.py SPEC OUT

runs as one rank of a gloo group on the CPU, joined through the ORP_* env
contract that tools/launch_torch.launch_local sets: it takes its rows of
the global batch in SPEC (a torch.save'd dict: the config dict, the state
dict, the numpy batch, the number of steps, the recipe, the seed), or
its batches of the data-parallel loader over that batch's rows (SPEC's
"loader"), steps them through the port's data-parallel step, and writes
OUT.{rank}.pt:
per step the losses, the stats, the (reduced, clipped) grads and the
state dict after it, and which samples each DropPath mask dropped.
run_steps(spec, None) is the one-process run of the same spec, in the
test's own process.  A SPEC of loader_cases instead writes every batch of
two epochs of each case's SizedDataset loader on this rank (run_loader).
Imports numpy, torch and the port only, and checks that in a rank.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from orientedreppoints_tpu_torch import apis  # noqa: E402
from orientedreppoints_tpu_torch.data.loader import DataLoader  # noqa: E402
from orientedreppoints_tpu_torch.models import swin  # noqa: E402
from orientedreppoints_tpu_torch.parallel import dist, train  # noqa: E402
from tools.launch_torch import launch_local  # noqa: E402


def build_step(spec: dict, group):
    """The model with the spec's weights and its step: "sgd" is
    tests/test_torch_train.py's port_steps recipe (stem and layer1 frozen,
    SGD, lr_schedule(iters_per_epoch=10)), "trainer" the config's own
    (apis.build_trainer with 10 iterations an epoch)."""
    cfg = spec["cfg"]
    model = apis.build_detector(cfg, "float32")
    model.load_state_dict(spec["state_dict"], strict=True)
    if spec["recipe"] == "sgd":
        train.freeze(model, train.default_frozen_prefixes(1))
        opt, sched = train.build_optimizer(
            model, train.lr_schedule(iters_per_epoch=10))
        step = train.make_train_step(
            model, apis.build_loss_config(cfg), opt, sched,
            img_norm=apis.build_img_norm(cfg), seed=spec["seed"],
            group=group)
    else:
        step = apis.build_trainer(model, cfg, iters_per_epoch=10,
                                  seed=spec["seed"], group=group)[2]
    return model, step


class RowsDataset:
    """The rows of a collated batch as a dataset of one aspect group:
    item i prepares row i's image at its true size and its valid gts; the
    items in `empty` prepare to None (as FilterEmpty drops one)."""

    def __init__(self, batch: dict, empty=()):
        self.batch, self.empty = batch, set(empty)
        self.flag = np.zeros(len(batch["images"]), np.uint8)

    def __len__(self):
        return len(self.flag)

    def prepare(self, i, rng):
        if i in self.empty:
            return None
        b = self.batch
        (h, w), valid = b["img_hw"][i], b["gt_valid"][i]
        return dict(img=b["images"][i, :h, :w], img_shape=(h, w, 3),
                    gt_bboxes=b["gt_polys"][i][valid],
                    gt_labels=b["gt_labels"][i][valid])


def step_batches(spec: dict, group) -> list:
    """The batch of each step on this rank: its rows of spec["batch"]
    (rank r the rows [r n / W, (r + 1) n / W)), or, when spec has
    "loader" (empty, batch_size, seed), one epoch's batches a step of the
    DataLoader over RowsDataset(spec["batch"], empty) on the group."""
    batch = spec["batch"]
    if "loader" in spec:
        kw = spec["loader"]
        dl = DataLoader(RowsDataset(batch, kw["empty"]), kw["batch_size"],
                        canvas_buckets=[batch["images"].shape[1:3]],
                        max_gt=batch["gt_polys"].shape[1], seed=kw["seed"],
                        group=dist.cpu_group(group))
        return [b for _ in range(spec["steps"]) for b in dl]
    w, r = dist.world_size(group), dist.rank(group)
    return [{k: v[r * len(v) // w:(r + 1) * len(v) // w]
             for k, v in batch.items()}] * spec["steps"]


def run_steps(spec: dict, group) -> dict:
    """This rank's batches (step_batches) through the step."""
    torch.manual_seed(0)
    model, step = build_step(spec, group)
    batches = step_batches(spec, group)
    drops, real = [], swin.drop_path

    def counting(y, rate, mask):
        out = real(y, rate, mask)
        if mask is not None and rate > 0:
            drops.append((out.reshape(out.shape[0], -1) == 0).all(1))
        return out

    swin.drop_path = counting
    try:
        records = []
        for batch in batches:
            stats = {}
            losses = step(batch, stats)
            records.append(dict(
                losses={k: float(v) for k, v in losses.items()},
                stats={k: stats[k].clone() for k in ("gt_inds",
                                                     "iou_gt_0p1")},
                grads={k: p.grad.clone() for k, p in model.named_parameters()
                       if p.requires_grad},
                state_dict={k: v.clone()
                            for k, v in model.state_dict().items()}))
    finally:
        swin.drop_path = real
    return dict(records=records, drops=drops,
                rows=[len(b["images"]) for b in batches])


class SizedDataset:
    """n items in two aspect groups: item i an image of a size (and a fill)
    of its own, drawn from the loader's RandomState too when random, with
    one gt; the items in `empty` prepare to None (as FilterEmpty drops
    one)."""

    def __init__(self, n: int = 14, random: bool = False, empty=()):
        self.flag = (np.arange(n) % 3 == 0).astype(np.uint8)
        self.random, self.empty = random, set(empty)

    def __len__(self):
        return len(self.flag)

    def prepare(self, i, rng):
        h, w, fill = 6 + (i * 5) % 17, 6 + (i * 7) % 13, i
        if self.random:
            h, fill = h + rng.randint(4), rng.randint(256)
        if i in self.empty:
            return None
        return dict(img=np.full((h, w, 3), fill, np.uint8),
                    img_shape=(h, w, 3),
                    gt_bboxes=np.full((1, 8), i, np.float32),
                    gt_labels=np.array([1 + i % 15]))


LOADER = dict(batch_size=4, canvas_buckets=[(8, 8), (16, 16), (24, 24)],
              max_gt=2, seed=3)


def load_epochs(dataset_kw: dict, group, epochs: int = 2) -> list:
    """Every batch of `epochs` epochs of a SizedDataset's loader."""
    dl = DataLoader(SizedDataset(**dataset_kw), group=group, **LOADER)
    return [list(dl) for _ in range(epochs)]


def run_loader(spec: dict, group) -> dict:
    """The loader cases of spec on this rank, and whether a global batch
    the ranks do not split is refused."""
    out = {name: load_epochs(kw, dist.cpu_group(group))
           for name, kw in spec["loader_cases"].items()}
    try:
        DataLoader(SizedDataset(), group=group, **dict(LOADER, batch_size=3))
    except ValueError:
        out["refuses_batch_3"] = True
    return out


def main(spec_path: str, out: str) -> int:
    group = dist.init_from_env("cpu")
    try:
        spec = torch.load(spec_path, weights_only=False)
        res = (run_loader if "loader_cases" in spec else run_steps)(
            spec, group)
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "flax", "cv2", "orientedreppoints_tpu"))
        assert not loaded, loaded
        torch.save(res, f"{out}.{dist.rank(group)}.pt")
    finally:
        dist.destroy(group)
    return 0


def launch(spec: dict, world: int, tmp, timeout: float = 240.0) -> list:
    """Run spec on `world` gloo ranks; their results in rank order."""
    spec_path, out = os.path.join(tmp, "spec.pt"), os.path.join(tmp, "out")
    torch.save(spec, spec_path)
    launch_local([sys.executable, os.path.abspath(__file__), spec_path, out],
                 world, cwd=REPO, timeout=timeout)
    return [torch.load(f"{out}.{r}.pt", weights_only=False)
            for r in range(world)]


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
