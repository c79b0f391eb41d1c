"""Faults planted in the program underneath a run, to show that the
comparison catches them (port_bench/calibrate.py reads them on the card,
port_bench/tests at a tiny size).  Each is a context manager that patches
the program where it looks the callable up, and undoes it on exit.

  serve.altered  the decode's boxes moved 4 px right where they are made;
  serve.half     the second half of each batch's canvases left blank;
  train.frozen   the optimizer's update skipped: the state stays as it was;
  train.half     the second half of each batch left out, the loss's means
                 taken over the rest;
  train.altered  the class loss returned 10% high where it is made.
"""

from __future__ import annotations

import contextlib
import importlib

_PKG = "orientedreppoints_tpu_torch"


@contextlib.contextmanager
def _patched(module: str, path: str, make):
    owner = importlib.import_module(f"{_PKG}.{module}")
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def _serve_altered(orig):
    def decode(*args, **kwargs):
        dets, labels, valid = orig(*args, **kwargs)
        dets = dets.clone()
        dets[..., -9:-1:2] += 4.0
        return dets, labels, valid
    return decode


def _serve_half(orig):
    def prepare(self, images):
        imgs, sfs = orig(self, images)
        imgs = imgs.clone()
        imgs[len(imgs) // 2:] = 0.0
        return imgs, sfs
    return prepare


def _train_frozen(orig):
    def step(self, *args, **kwargs):
        return None
    return step


def _train_half(orig):
    def to_device(batch, device):
        out = orig(batch, device)
        return {k: v[:len(v) // 2] for k, v in out.items()}
    return to_device


def _train_altered(orig):
    def compute_losses(*args, **kwargs):
        out = orig(*args, **kwargs)
        out["loss_cls"] = out["loss_cls"] * 1.1
        return out
    return compute_losses


def plant(name: str):
    """The context manager of the fault `name` (see the module doc)."""
    import torch

    if name == "train.frozen":
        return _frozen(torch)
    module, path, make = {
        "serve.altered": ("apis", "decode_detections", _serve_altered),
        "serve.half": ("serving", "Predictor.prepare", _serve_half),
        "train.half": ("parallel.train", "to_device", _train_half),
        "train.altered": ("parallel.train", "compute_losses",
                          _train_altered),
    }[name]
    return _patched(module, path, make)


@contextlib.contextmanager
def _frozen(torch):
    saved = {c: c.step for c in (torch.optim.SGD, torch.optim.AdamW)}
    for c in saved:
        c.step = _train_frozen(c.step)
    try:
        yield
    finally:
        for c, fn in saved.items():
            c.step = fn


NAMES = {"serve": ("serve.altered", "serve.half"),
         "train": ("train.frozen", "train.half", "train.altered")}
