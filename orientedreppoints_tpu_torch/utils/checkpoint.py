"""Training checkpoints in torch.save form (counterpart of
utils/checkpoint.py's save_checkpoint, load_checkpoint and
load_eval_variables).

A checkpoint is ckpt_dir/epoch_{N}.pt holding the model's state dict, the
SGD state with its momentum buffers, the LambdaLR state, the optimizer
step count and meta (the config text, the classes, the epoch N).  It is
written to a temporary file in ckpt_dir and renamed into place, so a
reader never sees half a file.  Loading is strict: a missing or extra
tensor, or an optimizer of other parameter groups, raises.  Reading the
JAX package's orbax checkpoints is not ported.
"""

from __future__ import annotations

import os
import os.path as osp
import re

import torch

_NAME = re.compile(r"^epoch_(\d+)\.pt$")
KEYS = ("model", "optimizer", "scheduler", "step", "meta")


def save_checkpoint(ckpt_dir: str, epoch: int, model, optimizer, scheduler,
                    step: int, meta: dict | None = None) -> str:
    """Write ckpt_dir/epoch_{epoch}.pt atomically; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = osp.join(ckpt_dir, f"epoch_{epoch}.pt")
    payload = dict(model=model.state_dict(), optimizer=optimizer.state_dict(),
                   scheduler=scheduler.state_dict(), step=int(step),
                   meta=dict(meta or {}, epoch=int(epoch)))
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The path of the highest epoch in ckpt_dir, or None."""
    if not osp.isdir(ckpt_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir))
              if m]
    return osp.join(ckpt_dir, f"epoch_{max(epochs)}.pt") if epochs else None


def _read(path: str) -> dict:
    """A checkpoint file, or the latest one of a directory."""
    if osp.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no epoch_*.pt checkpoint in {path}")
        path = found
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or set(payload) != set(KEYS):
        raise ValueError(f"{path} is not a checkpoint of this package")
    return payload


def load_checkpoint(path: str, model, optimizer, scheduler):
    """Restore model, optimizer and scheduler in place from a checkpoint
    file or the latest of a directory; returns (step, meta)."""
    payload = _read(path)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    scheduler.load_state_dict(payload["scheduler"])
    return payload["step"], payload["meta"]


def load_eval_variables(path: str, model) -> dict:
    """Restore only the model's weights (strictly), for inference;
    returns the checkpoint's meta."""
    payload = _read(path)
    model.load_state_dict(payload["model"], strict=True)
    return payload["meta"]
