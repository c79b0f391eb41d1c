"""Process groups for data-parallel training (counterpart of the
jax.distributed initialisation in tools/train.py and of the reference's
NCCL init_dist).

One process a card.  A process joins its group through the env contract
the JAX package's tools/train.py reads (ORP_COORDINATOR_ADDRESS: host:port
of rank 0's TCP store, ORP_NUM_PROCESSES, ORP_PROCESS_ID), plus
ORP_LOCAL_RANK, its card on this host (cuda:{ORP_LOCAL_RANK}).  The group
is NCCL on a CUDA device and gloo on the CPU or when asked for; an init
that fails raises, nothing falls back.

Every helper takes the group explicitly; None means one process, where
all_reduce_sum and barrier do nothing and rank / world_size are 0 / 1.
tools/dist_train_torch.sh starts one host's processes of a group.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist

def local_rank() -> int:
    """This process's card on its host (ORP_LOCAL_RANK, default 0)."""
    return int(os.environ.get("ORP_LOCAL_RANK") or 0)


def init(address: str, world: int, rank: int, device,
         backend: str | None = None):
    """Join the group at tcp://address as `rank` of `world`: NCCL when the
    device is CUDA, gloo on the CPU or when backend is "gloo".  A CUDA
    device becomes the current one.  Returns the group (WORLD)."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, got {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    return dist.group.WORLD


def init_from_env(device, backend: str | None = None):
    """init() from the ORP_* env contract; None (no group) when
    ORP_COORDINATOR_ADDRESS is unset or empty."""
    address = os.environ.get("ORP_COORDINATOR_ADDRESS")
    if not address:
        return None
    return init(address, int(os.environ["ORP_NUM_PROCESSES"]),
                int(os.environ["ORP_PROCESS_ID"]), device, backend)


def destroy(group) -> None:
    if group is not None:
        dist.destroy_process_group()


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def world_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the group, in place (t itself without a group)."""
    if group is not None:
        dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, dist.ReduceOp.MAX, group=group)
    return t


def row_counts(n: int, group, device="cpu") -> list[int]:
    """Every rank's row count in rank order, this rank holding n: the
    ranks of a group may hold uneven shares of one global batch (a loader
    whose pipeline drops samples).  [n] without a group."""
    w = world_size(group)
    if w == 1:
        return [n]
    t = torch.zeros(w, dtype=torch.int64, device=device)
    t[rank(group)] = n
    return [int(c) for c in all_reduce_sum(t, group).tolist()]


def gather_rows(t: torch.Tensor, group, counts: Sequence[int]) -> torch.Tensor:
    """The ranks' (counts[r], ...) tensors stacked in rank order ->
    (sum(counts), ...): a sum of zero-padded copies, since gloo gathers
    no CUDA tensor.  counts: row_counts' list."""
    if world_size(group) == 1:
        return t
    r = rank(group)
    if t.shape[0] != counts[r]:
        raise ValueError(f"gather_rows: rank {r} holds {t.shape[0]} rows, "
                         f"counts say {counts[r]}")
    lo = sum(counts[:r])
    out = torch.zeros((sum(counts),) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[lo:lo + counts[r]] = t
    return all_reduce_sum(out, group)


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


def cpu_group(group):
    """A group over the same ranks for host tensors (the loader's): the
    group itself when it is gloo, else a new gloo group (every rank calls
    it); None without a group."""
    if group is None or dist.get_backend(group) == "gloo":
        return group
    return dist.new_group(backend="gloo")
