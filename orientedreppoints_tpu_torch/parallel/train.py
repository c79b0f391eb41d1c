"""One-device training step (counterpart of parallel/train.py, SGD recipe).

Optimizer parity with the JAX package's optax chain
(configs/dota/orientedreppoints_r50_demo.py):
  * frozen_stages=1: the stem and layer1_* take no update and no decay
    (their parameters get requires_grad=False, so autograd and the
    optimizer never see them);
  * the global-norm clip at 35 runs first, over the trainable grads only,
    as optax.clip_by_global_norm does it (g / norm * max_norm when the norm
    is at least max_norm);
  * then torch.optim.SGD adds weight decay to the grad and keeps the
    momentum trace (its first buffer is the grad), as add_decayed_weights
    + trace do;
  * the LR is mmcv's step schedule with linear warmup from lr / 3 by step
    count, computed in f32 as the JAX schedule is (LambdaLR over lr 1.0).

apis.build_trainer assembles this recipe from a config; data/loader.py
feeds it and utils/checkpoint.py saves and restores it.  Not ported yet:
AdamW and data-parallel (DDP) training (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core.loss_head import LossConfig, compute_losses

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
    as state_dict name prefixes."""
    out = ["backbone.stem."] if frozen_stages >= 0 else []
    return out + [f"backbone.layer{s}_" for s in range(1, frozen_stages + 1)]


def freeze(model: torch.nn.Module, prefixes: Sequence[str]) -> None:
    """requires_grad=False on every parameter under a frozen prefix."""
    for name, p in model.named_parameters():
        if any(name.startswith(pre) for pre in prefixes):
            p.requires_grad_(False)


def build_optimizer(model: torch.nn.Module, schedule: Callable[[int], float],
                    momentum: float = 0.9, weight_decay: float = 1e-4):
    """SGD with momentum and weight decay over the trainable parameters, and
    a LambdaLR that sets the LR to schedule(step) (base LR 1.0).
    Returns (optimizer, scheduler)."""
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.SGD(params, lr=1.0, momentum=momentum,
                          weight_decay=weight_decay)
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


def make_train_step(model: torch.nn.Module, loss_cfg: LossConfig, optimizer,
                    scheduler, grad_clip: float = 35.0,
                    img_norm: dict | None = None):
    """A step(batch) -> loss dict (with loss_total) that updates the model
    in place.

    batch: the collated dict (data/loader.py layout): images (B, H, W, 3),
    uint8 when img_norm is given (normalized on the device), else
    normalized f32; gt_polys (B, G, 8), gt_labels (B, G), gt_valid (B, G),
    img_hw (B, 2).  step(batch, stats) fills `stats` as compute_losses
    does.
    """
    params = [p for g in optimizer.param_groups for p in g["params"]]
    device = params[0].device

    def step(batch: dict, stats: dict | None = None) -> dict:
        batch = to_device(batch, device)
        imgs = batch["images"]
        if img_norm is not None:
            imgs = device_normalize(imgs, batch["img_hw"], **img_norm)
        outs = model(imgs)
        losses = compute_losses(outs, batch["gt_polys"], batch["gt_labels"],
                                batch["gt_valid"], batch["img_hw"], loss_cfg,
                                stats=stats)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        optimizer.zero_grad(set_to_none=False)
        total.backward()
        clip_by_global_norm_([p.grad for p in params], grad_clip)
        optimizer.step()
        scheduler.step()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss_total"] = total.detach()
        return losses

    for p in params:  # every trainable leaf decays, as optax applies it
        p.grad = torch.zeros_like(p)
    return step
