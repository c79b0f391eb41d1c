"""Timing and tracing (counterpart of utils/profiling.py, after the
reference's mmdet/utils/profiling.py):

  * profile_time: a wall clock around a block that first waits for the
    CUDA devices of the tensors in `stream`, so an asynchronous launch is
    timed to its end;
  * trace: torch.profiler over a block, CPU activity and, where a card is
    present, CUDA activity, written as a Chrome trace into log_dir;
  * annotate: the program's one span primitive, a named range inside an
    active profiler's trace (torch.profiler.record_function), on the
    clock of the device events it launches; with no profiler on, a shared
    no-op after one check, so the spans cost nothing and stay out of
    torch.export graphs;
  * span_rows: the SPANS rows of a profiled window's key_averages().

SPANS lists every range the program opens: a serving batch's and a
training step's, each nested in time inside the one above it (a span's
parent is the range that encloses it).
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


# name -> where it is opened and what it covers
SPANS = {
    "orp.serve.call": "serving.Predictor.__call__, a chunk: entry to "
                      "per-class results",
    "orp.serve.prepare": "Predictor.prepare: per-image H2D copy, resize, "
                         "normalize, paste, stack",
    "orp.forward": "OrientedRepPointsDetector.forward: backbone, FPN, head",
    "orp.decode": "decode_detections: top-k, min-area rects, over-mask, "
                  "scan",
    "orp.serve.fetch": "Predictor.__call__: the three results' copies to "
                       "the host (the host waits on the card here)",
    "orp.serve.results": "Predictor.__call__: rbbox2result on the host",
    "orp.train.step": "parallel/train.make_train_step's step",
    "orp.train.to_device": "the step: the batch's H2D copies",
    "orp.train.normalize": "the step: device_normalize",
    "orp.loss": "core/loss_head.compute_losses",
    "orp.loss.assign": "compute_losses: level set-up, both assigners, hull "
                       "IoU",
    "orp.loss.apaa": "compute_losses: APAA without gradient, the final "
                     "labels",
    "orp.loss.terms": "compute_losses: focal, GIoU and spatial terms, the "
                      "init levels, stats",
    "orp.train.backward": "the step: zero_grad and the backward (autograd's "
                          "launches fall inside it in time)",
    "orp.train.optimizer": "the step: the group's all-reduce, the clip, the "
                           "optimizer and the schedule",
}

_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A range named `name` in the active profiler's trace; with no
    profiler on, a shared no-op context (no record_function, no op)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def span_rows(events, count: int) -> list[str]:
    """The SPANS rows of a profiled window's key_averages(): calls, and
    host and device ms each of `count` batches or steps.  Device ms are
    those of the work the span's own thread launched inside it (the
    backward's, launched on autograd's thread, is not under
    orp.train.backward here); the copy of each range that the profiler
    puts on the device's timeline is left out."""
    return [f"{e.key:22s} calls {e.count:4d}  host "
            f"{e.cpu_time_total / 1e3 / count:9.3f} ms  device "
            f"{e.device_time_total / 1e3 / count:9.3f} ms"
            for e in sorted(events, key=lambda e: e.key)
            if e.key in SPANS
            and e.device_type == torch.autograd.DeviceType.CPU]
