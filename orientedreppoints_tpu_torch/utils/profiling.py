"""Timing and tracing (counterpart of utils/profiling.py, after the
reference's mmdet/utils/profiling.py):

  * profile_time: a wall clock around a block that first waits for the
    CUDA devices of the tensors in `stream`, so an asynchronous launch is
    timed to its end;
  * trace: torch.profiler over a block, CPU activity and, where a card is
    present, CUDA activity, written as a Chrome trace into log_dir;
  * annotate: a named range inside a trace (torch.profiler.record_function).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch


def _cuda_devices(stream, found: set) -> set:
    """The CUDA devices of every tensor in nested lists, tuples and dicts."""
    if isinstance(stream, torch.Tensor):
        if stream.is_cuda:
            found.add(stream.device)
    elif isinstance(stream, dict):
        for v in stream.values():
            _cuda_devices(v, found)
    elif isinstance(stream, (list, tuple)):
        for v in stream:
            _cuda_devices(v, found)
    return found


@contextlib.contextmanager
def profile_time(name: str, stream=None, logger: logging.Logger | None = None):
    """Time a block; at its end synchronize the CUDA device of every tensor
    in `stream` before reading the clock, and log
    '[profile] name: X ms'."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        for dev in _cuda_devices(stream, set()):
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) * 1e3
        (logger or logging.getLogger("profile")).info(
            f"[profile] {name}: {dt:.2f} ms")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around a block (CUDA activity too when a card is
    present), its Chrome trace written to log_dir/trace.json; yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range inside an active trace."""
    return torch.profiler.record_function(name)
