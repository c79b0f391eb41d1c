"""Data-parallel inference over the cards of this host (counterpart of
parallel/infer.py: data_mesh, round_up_batch, shard_infer).

As in the JAX package, one process drives every local card: the padded
batch splits batch-first into equal contiguous shards, each card runs the
whole single-device forward + decode (+ NMS) on its shard with its own
replica of the model, and there is no collective on this path; the
outputs are gathered on the first card.  The host enqueues the shards one
after another and waits for none of them, so the cards overlap where the
shard's program does not synchronise the host.

With devices None every function here is the one-device call, unchanged.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Sequence

import torch

__all__ = ["data_devices", "round_up_batch", "shard_infer"]


def data_devices(min_devices: int = 2) -> list[torch.device] | None:
    """Every visible CUDA device; None below min_devices."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < min_devices:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def round_up_batch(batch_size: int,
                   devices: Sequence[torch.device] | None) -> int:
    """The smallest batch >= batch_size that the devices split evenly."""
    if not devices:
        return batch_size
    n = len(devices)
    return -(-batch_size // n) * n


def _replicas(model: torch.nn.Module, devices: Sequence[torch.device]):
    """One model a device, the model itself on the first device that is
    its own, copies elsewhere (a device listed twice gets two)."""
    home = next(model.parameters()).device
    out, own = [], False
    for d in devices:
        if d == home and not own:
            out.append(model)
            own = True
        else:
            out.append(copy.deepcopy(model).to(d))
    return out


def shard_infer(fn: Callable, model: torch.nn.Module,
                devices: Sequence[torch.device] | None) -> Callable:
    """A callable infer(*arrays) running fn(model, *arrays) data-parallel.

    arrays: batch-first tensors whose batch the devices split evenly (see
    round_up_batch); fn returns a batch-first tensor or a tuple of them.
    Shard i of every array goes to devices[i] and through fn with that
    device's replica of the model, under inference mode; the outputs come
    back concatenated on devices[0].  The replicas are made here, from the
    model's weights at this call.  devices None: fn(model, *arrays)."""
    if devices is None:
        return lambda *arrays: fn(model, *arrays)
    devices = [torch.device(d) for d in devices]
    replicas = _replicas(model, devices)
    n = len(devices)

    def infer(*arrays):
        b = arrays[0].shape[0]
        if b % n:
            raise ValueError(f"shard_infer: batch {b} does not split over "
                             f"{n} devices (round_up_batch)")
        per = b // n
        outs = []
        for i, (dev, replica) in enumerate(zip(devices, replicas)):
            shard = [a[i * per:(i + 1) * per].to(dev, non_blocking=True)
                     for a in arrays]
            on = (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext())
            with torch.inference_mode(), on:
                outs.append(fn(replica, *shard))
        single = isinstance(outs[0], torch.Tensor)
        parts = [(o,) if single else tuple(o) for o in outs]
        gathered = tuple(torch.cat([p[k].to(devices[0]) for p in parts])
                         for k in range(len(parts[0])))
        return gathered[0] if single else gathered

    return infer

