"""The training step (counterpart of parallel/train.py), on one device
or data-parallel over a process group, with the SGD and the AdamW recipes
of the JAX package's optax chains.

Optimizer parity (configs/dota/orientedreppoints_r50_demo.py,
configs/dota/orientedreppoints_swin_tiny_demo.py):
  * frozen_stages=1: ResNet's stem and layer1_* take no update and no
    decay (their parameters get requires_grad=False, so autograd and the
    optimizer never see them); Swin, HRNet (stem1, stem2, layer1) and
    SSD-VGG have no module of those names, so nothing freezes, as in JAX;
  * the global-norm clip at 35 runs first, over the trainable grads only,
    as optax.clip_by_global_norm does it (g / norm * max_norm when the norm
    is at least max_norm);
  * SGD: torch.optim.SGD adds weight decay to the grad and keeps the
    momentum trace (its first buffer is the grad), as add_decayed_weights
    + trace do;
  * AdamW: scale_by_adam(0.9, 0.999, 1e-8), then the decay added under a
    mask, then the LR: -lr (m^ / (sqrt(v^) + eps) + wd p), which is
    torch.optim.AdamW's arithmetic (rounded in another order) over two
    parameter groups, the no-decay group at weight_decay 0.  The config's
    betas are ignored, as the optax chain fixes them;
  * the LR is mmcv's step schedule with linear warmup from lr / 3 by step
    count, computed in f32 as the JAX schedule is (LambdaLR over lr 1.0).

The step runs the model in train mode (and restores its mode after), so
a Swin backbone's DropPath fires.  Its masks are the JAX step's: the
step's key is jax.random.fold_in(jax.random.key(seed), step count)
(dropout_key, the JAX step's dropout_rng folded with state.step), under
which the model draws flax's keys and jax.random's masks on the host
(models/swin.py, utils/jax_random.py).  A resumed run draws the masks of
an uninterrupted one without saving any generator state.

Data parallelism computes what the JAX mesh step computes: one step of
the global batch.  Its losses divide by counts over the whole batch
(num_pos, each level's positives, the spatial losses' counts), so stock
DDP, which averages the grads of per-rank losses over per-rank counts, is
not it.  With a group, each rank (one process a card, parallel/dist.py)
holds its rows of the global batch, in rank order (the shares may differ
in size when the loader drops samples; the step exchanges the ranks' row
counts first): compute_losses sums every count over the group before it
divides, so a rank's loss is its rows' share of the global loss; the
grads are summed over the group (one flat all-reduce), then clipped by
their global norm, then the optimizer steps every replica alike;
DropPath draws the global batch's masks and keeps the rank's rows
(models/swin.BatchRows, at the rank's row offset).  The losses returned
are summed over the group, the per-image stats gathered, so every rank
sees the one-process step's.

apis.build_trainer assembles a recipe from a config; data/loader.py
feeds it and utils/checkpoint.py saves and restores it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..core.loss_head import LossConfig, compute_losses
from ..models.swin import BatchRows
from ..utils import jax_random
from ..utils.determinism import deterministic
from . import dist

BATCH_KEYS = ("images", "gt_polys", "gt_labels", "gt_valid", "img_hw")


def lr_schedule(base_lr: float = 0.008, warmup_iters: int = 500,
                warmup_ratio: float = 1.0 / 3.0,
                step_epochs: Sequence[int] = (24, 32, 38),
                iters_per_epoch: int = 1000, gamma: float = 0.1):
    """step -> LR (a Python float holding the f32 value the JAX schedule
    gives)."""
    boundaries = torch.tensor([e * iters_per_epoch for e in step_epochs],
                              dtype=torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731

    def fn(step: int) -> float:
        s = f32(step)
        n_decays = (s >= boundaries).sum().to(torch.float32)
        lr = f32(base_lr) * torch.pow(f32(gamma), n_decays)
        k = torch.clamp(s / warmup_iters, 0.0, 1.0)
        factor = f32(warmup_ratio) + f32(1.0 - warmup_ratio) * k
        return float(lr * factor if step < warmup_iters else lr)

    return fn


def default_frozen_prefixes(frozen_stages: int = 1) -> list[str]:
    """ResNet frozen_stages: the stem, then layer1 .. layer{frozen_stages},
    as state_dict name prefixes.  Each ends where JAX's key tuple does
    (("backbone", "stem"), ("backbone", f"layer{s}_{blk}")): "stem."
    takes no HRNet stem1 / stem2 and "layer1_" no HRNet layer1."""
    out = ["backbone.stem."] if frozen_stages >= 0 else []
    return out + [f"backbone.layer{s}_" for s in range(1, frozen_stages + 1)]


def freeze(model: torch.nn.Module, prefixes: Sequence[str]) -> None:
    """requires_grad=False on every parameter under a frozen prefix."""
    for name, p in model.named_parameters():
        if any(name.startswith(pre) for pre in prefixes):
            p.requires_grad_(False)


# JAX's AdamW no-decay substrings (parallel/train.py build_optimizer)
ADAMW_NO_DECAY = ("bias", "norm", "gn", "bn")


def decayed(name: str) -> bool:
    """Whether AdamW decays the parameter of this state_dict name: JAX's
    rule on the flax path, none of the substrings in the lower-cased
    name.  The port's names are the flax paths joined by dots with the
    leaf renamed (kernel or a norm's scale -> weight), and neither leaf
    name holds a substring, so the rule gives the same set."""
    return not any(t in name.lower() for t in ADAMW_NO_DECAY)


def build_optimizer(model: torch.nn.Module, schedule: Callable[[int], float],
                    optimizer: str = "sgd", momentum: float = 0.9,
                    weight_decay: float = 1e-4):
    """SGD with momentum and weight decay, or AdamW with weight decay on
    the `decayed` parameters only, over the trainable parameters, and a
    LambdaLR that sets the LR to schedule(step) (base LR 1.0).
    Returns (optimizer, scheduler)."""
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    if optimizer == "sgd":
        opt = torch.optim.SGD([p for _, p in named], lr=1.0,
                              momentum=momentum, weight_decay=weight_decay)
    elif optimizer == "adamw":
        groups = [dict(params=[p for k, p in named if decayed(k)],
                       weight_decay=weight_decay),
                  dict(params=[p for k, p in named if not decayed(k)],
                       weight_decay=0.0)]
        opt = torch.optim.AdamW(groups, lr=1.0, betas=(0.9, 0.999),
                                eps=1e-8)
    else:
        raise ValueError(f"optimizer {optimizer}")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm in place: g / norm * max_norm when the
    global norm is at least max_norm.  Returns the norm (a tensor)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def device_normalize(imgs, img_hw, mean, std, to_rgb: bool = True):
    """Normalize raw (uint8) canvases on the device: optional BGR -> RGB,
    (x - mean) / std, and 0 beyond each image's true extent img_hw (B, 2),
    as the host pipeline's Normalize -> Pad(0) gives."""
    x = imgs.to(torch.float32)
    if to_rgb:
        x = x.flip(-1)
    dev = x.device
    x = (x - torch.tensor(mean, dtype=torch.float32, device=dev)) / \
        torch.tensor(std, dtype=torch.float32, device=dev)
    h, w = imgs.shape[1], imgs.shape[2]
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    hw = img_hw.to(dev)
    valid = (yy < hw[:, 0, None, None]) & (xx < hw[:, 1, None, None])
    return x * valid[..., None]


def to_device(batch: dict, device) -> dict:
    """The collated batch dict (numpy arrays or tensors) on `device`."""
    return {k: torch.as_tensor(batch[k], device=device) for k in BATCH_KEYS}


def dropout_key(seed: int, step: int) -> np.ndarray:
    """The DropPath key of one step, from (seed, step) alone: the JAX
    step's jax.random.fold_in(jax.random.key(seed), step) as its (2,)
    uint32 data (the JAX step's key without a dropout_rng is key(0))."""
    return jax_random.fold_in(jax_random.key(seed), step)


def all_reduce_grads_(grads: Sequence[torch.Tensor], group) -> None:
    """Sum the grads over the group in place, as one flat buffer."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce_sum(flat, group)
    lo = 0
    for g in grads:
        g.copy_(flat[lo:lo + g.numel()].view_as(g))
        lo += g.numel()


def make_train_step(model: torch.nn.Module, loss_cfg: LossConfig, optimizer,
                    scheduler, grad_clip: float = 35.0,
                    img_norm: dict | None = None, seed: int = 0,
                    group=None):
    """A step(batch) -> loss dict (with loss_total) that updates the model
    in place.  The forward runs in train mode with dropout_key(seed, the
    scheduler's step count) for DropPath.

    batch: the collated dict (data/loader.py layout): images (B, H, W, 3),
    uint8 when img_norm is given (normalized on the device), else
    normalized f32; gt_polys (B, G, 8), gt_labels (B, G), gt_valid (B, G),
    img_hw (B, 2).  step(batch, stats) fills `stats` as compute_losses
    does.

    group: a process group (parallel/dist.py) whose every rank runs this
    step on its own rows of one global batch, in rank order, from the same
    parameters; the step is then the one-process step of the global batch
    (module docstring).  The ranks' row counts may differ, none may be 0.
    None: one process.

    Every step runs under utils/determinism.deterministic(), so one seed
    gives the same parameters on every run, as the JAX step does.
    """
    params = [p for g in optimizer.param_groups for p in g["params"]]
    device = params[0].device
    rank = dist.rank(group)
    reduce = None if group is None else (
        lambda t: dist.all_reduce_sum(t, group))

    def step(batch: dict, stats: dict | None = None) -> dict:
        with deterministic():
            batch = to_device(batch, device)
            imgs = batch["images"]
            if img_norm is not None:
                imgs = device_normalize(imgs, batch["img_hw"], **img_norm)
            was_training = model.training
            model.train()
            key = dropout_key(seed, scheduler.last_epoch)
            if group is not None:  # the ranks' shares may differ (loader)
                counts = dist.row_counts(len(imgs), group, device)
                key = BatchRows(key, sum(counts[:rank]), sum(counts))
            try:
                outs = model(imgs, key)
            finally:
                model.train(was_training)
            losses = compute_losses(
                outs, batch["gt_polys"], batch["gt_labels"],
                batch["gt_valid"], batch["img_hw"], loss_cfg, stats=stats,
                reduce=reduce)
            total = sum(v for k, v in losses.items() if k.startswith("loss"))
            optimizer.zero_grad(set_to_none=False)
            total.backward()
            if group is not None:
                all_reduce_grads_([p.grad for p in params], group)
            clip_by_global_norm_([p.grad for p in params], grad_clip)
            optimizer.step()
            scheduler.step()
            losses = {k: v.detach() for k, v in losses.items()}
            losses["loss_total"] = total.detach()
            if group is not None:
                names = list(losses)
                summed = dist.all_reduce_sum(
                    torch.stack([losses[k].float() for k in names]), group)
                losses = dict(zip(names, summed.unbind()))
                if stats is not None:
                    for k in ("gt_inds", "iou_gt_0p1"):
                        stats[k] = dist.gather_rows(stats[k], group, counts)
            return losses

    for p in params:  # every trainable leaf decays, as optax applies it
        p.grad = torch.zeros_like(p)
    # what step_cost_analysis saves and restores around a counted step
    step.model, step.optimizer, step.scheduler = model, optimizer, scheduler
    return step


def step_cost_analysis(step, batch: dict) -> float:
    """FLOPs of one train step, forward and backward (counterpart of the
    JAX package's step_cost_analysis), counted as tools/get_flops_torch.py
    counts them: torch.utils.flop_counter.FlopCounterMode, 2 x the
    multiply-adds of every convolution and matrix product (the DCN's
    sampling, the assigners' kernels and elementwise work are not
    counted).  JAX's figure is XLA's cost analysis of the compiled step,
    elementwise work included, so the two numbers differ by definition.

    step: a make_train_step step; it runs once on batch, and the model's
    parameters and buffers, the optimizer's and the scheduler's state are
    put back after, so the count changes nothing.  Raises if the count
    fails or comes to 0; never returns None.
    """
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    saved = [copy.deepcopy(x.state_dict())
             for x in (step.model, step.optimizer, step.scheduler)]
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            step(batch)
    finally:
        for x, state in zip((step.model, step.optimizer, step.scheduler),
                            saved):
            x.load_state_dict(state)
    flops = float(counter.get_total_flops())
    if not flops > 0:
        raise RuntimeError("step_cost_analysis: the step counted no FLOPs")
    return flops
