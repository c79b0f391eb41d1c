"""The training recipe: uint8 canvases normalized on the card, the
train-mode forward (Swin's DropPath masks from the step's key), the loss,
the global-norm clip, and SGD with momentum and weight decay or AdamW with
decay on the parameters whose name holds none of bias, norm, gn, bn; the
learning rate warms up linearly from ratio x lr over warmup_iters steps,
then steps down by 10 at the given epochs.

A step takes its images a few at a time: a first pass without gradient
gives each group's assignments and counts, and a second pass takes each
group's loss over the batch's counts and adds up the grads.
"""

from __future__ import annotations

import numpy as np
import torch

from . import detector, jax_random
from .loss import loss_config, losses, targets

NO_DECAY = ("bias", "norm", "gn", "bn")


def normalize(images, img_hw, mean, std, to_rgb=True):
    x = images.float()
    if to_rgb:
        x = x.flip(-1)
    x = (x - torch.tensor(mean, device=x.device)) / torch.tensor(
        std, device=x.device)
    h, w = x.shape[1], x.shape[2]
    hw = img_hw.to(x.device)
    ok = ((torch.arange(h, device=x.device)[None, :, None] < hw[:, 0, None,
                                                                  None])
          & (torch.arange(w, device=x.device)[None, None, :] < hw[:, 1, None,
                                                                   None]))
    return x * ok[..., None]


def learning_rate(cfg: dict, step: int, iters_per_epoch: int) -> float:
    opt, lr = cfg["optimizer"], cfg["lr_config"]
    f = np.float32
    base = f(opt["lr"]) * f(0.1) ** f(sum(step >= e * iters_per_epoch
                                          for e in lr["step"]))
    if step >= lr["warmup_iters"]:
        return float(base)
    k = min(max(f(step) / f(lr["warmup_iters"]), f(0)), f(1))
    ratio = f(lr["warmup_ratio"])
    return float(base * (ratio + (f(1) - ratio) * k))


def dropout_key(seed: int, step: int) -> np.ndarray:
    return jax_random.fold_in(jax_random.key(seed), step)


class Trainer:
    """params: {name: float32 tensor} (the trainable ones require grad)."""

    def __init__(self, cfg: dict, params: dict, seed: int, chunk: int = 2,
                 iters_per_epoch: int = 1000):
        self.cfg, self.p, self.seed, self.chunk = cfg, params, seed, chunk
        self.ipe = iters_per_epoch
        self.lcfg = loss_config(cfg)
        self.names = [k for k, v in params.items() if v.requires_grad]
        self.state = {k: {} for k in self.names}
        self.t = 0
        pipe = cfg["data"]["train"]["pipeline"]
        norm = next(s for s in pipe if s["type"] == "Normalize")
        self.norm = (norm["mean"], norm["std"], norm.get("to_rgb", True))

    def _rows(self, batch, lo, hi):
        return {k: batch[k][lo:hi] for k in ("gt_polys", "gt_labels",
                                             "gt_valid", "img_hw")}

    def step(self, batch: dict) -> dict:
        """One step on a batch (tensors on the device) -> loss values."""
        imgs = normalize(batch["images"], batch["img_hw"], *self.norm)
        b = imgs.shape[0]
        key = dropout_key(self.seed, self.t)
        groups = [(lo, min(b, lo + self.chunk))
                  for lo in range(0, b, self.chunk)]
        tgs, counts = [], {}
        for lo, hi in groups:
            with torch.no_grad():
                outs = detector.forward(self.p, imgs[lo:hi], self.cfg,
                                        key=(key, lo, b), train=True)
                tg = targets(outs, self._rows(batch, lo, hi), self.lcfg)
            tgs.append(tg)
            for k, v in tg["counts"].items():
                counts[k] = counts.get(k, 0) + v
            del outs
        for k in self.names:
            self.p[k].grad = None
        values = {}
        for (lo, hi), tg in zip(groups, tgs):
            outs = detector.forward(self.p, imgs[lo:hi], self.cfg,
                                    key=(key, lo, b), train=True)
            terms = losses(outs, tg, counts, self.lcfg)
            total = sum(terms.values())
            total.backward()
            for k, v in terms.items():
                values[k] = values.get(k, 0.0) + float(v.detach())
            del outs, terms, total
        values["loss_total"] = sum(values.values())
        self._update()
        self.t += 1
        return values

    def _update(self):
        opt = self.cfg["optimizer"]
        max_norm = self.cfg["optimizer_config"]["grad_clip"]["max_norm"]
        g = [self.p[k].grad for k in self.names]
        norm = torch.sqrt(sum((x * x).sum() for x in g))
        if float(norm) >= max_norm:
            for x in g:
                x.mul_(max_norm / norm)
        lr = learning_rate(self.cfg, self.t, self.ipe)
        wd = opt.get("weight_decay", 1e-4)
        with torch.no_grad():
            for k in self.names:
                p, grad, st = self.p[k], self.p[k].grad, self.state[k]
                if opt["type"] == "SGD":
                    d = grad + wd * p
                    st["buf"] = d.clone() if "buf" not in st else \
                        opt.get("momentum", 0.9) * st["buf"] + d
                    p -= lr * st["buf"]
                else:
                    b1, b2, eps, n = 0.9, 0.999, 1e-8, self.t + 1
                    if not any(s in k.lower() for s in NO_DECAY):
                        p *= 1 - lr * wd
                    st["m"] = b1 * st.get("m", 0.0) + (1 - b1) * grad
                    st["v"] = b2 * st.get("v", 0.0) + (1 - b2) * grad * grad
                    mh = st["m"] / (1 - b1 ** n)
                    vh = st["v"] / (1 - b2 ** n)
                    p -= lr * mh / (torch.sqrt(vh) + eps)
