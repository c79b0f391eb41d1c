"""What both drivers share: the device, set-up and memory readings, the
traced window and its per-layer metrics, and the result line."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from . import spans, trace
from .main import Cell, load_metric


@dataclasses.dataclass
class Run:
    """What a per-layer reader gets of a traced window."""
    view: trace.TraceView
    rec: spans.Recorder
    window_s: float  # host clock over the traced window
    items: int  # images served or trained in it
    steps: int  # batches or steps in it
    conf: dict  # the configuration's benchmark file
    kind: str  # "serve" or "train"
    canvas: int  # the mix's canvas side
    rate: float  # images a second over the untraced window before it


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_info(cell: Cell, peak: int) -> dict:
    dev = torch.device(cell.device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def memory_peak(cell: Cell) -> int:
    if torch.device(cell.device).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


def reset_peak(cell: Cell) -> None:
    if torch.device(cell.device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def release() -> None:
    """Give the card's cached blocks back once the program is dropped."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Phases:
    """Set-up's phases on stderr, each its seconds since the last mark
    (the first since the process started)."""

    def __init__(self, cell: Cell):
        self.t = cell.t_start
        self.parts = [("imports", time.perf_counter() - self.t)]
        self.t += self.parts[0][1]

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now
        if name == "warm-up":
            say("set-up: " + ", ".join(f"{k} {v:.2f} s"
                                       for k, v in self.parts))


def rate(seconds: float, one, device) -> float:
    """Items a second over an untraced window of about `seconds`: one()
    runs one batch or step and returns its items; the window ends once
    the card has finished."""
    n = 0
    sync(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        n += one()
    sync(device)
    window = time.perf_counter() - t0
    say(f"untraced window {window:.3f} s, {n} images")
    return n / window


def traced(cell: Cell, body, kind: str, rate: float):
    """Run body() -> (items, steps) under the profiler with the cell's
    metric wrappers -> (metrics dict, device extras, breakdown); `rate`,
    the untraced window's images a second, goes to the readers."""
    readers = {m["name"]: load_metric(m["name"]) for m in cell.per_layer}
    rec = spans.Recorder()
    undo = spans.install([w for r in readers.values() for w in r.WRAPS],
                         rec)
    box = []
    try:
        sync(cell.device)
        t0 = time.perf_counter()
        with trace.profiled(box):
            rec.on = True
            items, steps = body()
            sync(cell.device)
            rec.on = False
            window = time.perf_counter() - t0
    finally:
        undo()
    view = box[0]
    run = Run(view=view, rec=rec, window_s=window, items=items, steps=steps,
              conf=cell.conf, kind=kind, canvas=cell.traffic["canvas"],
              rate=rate)
    units = {m["name"]: m["unit"] for m in cell.per_layer}
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    extra = {"busy_s": view.busy_s(), "window_s": view.window_s()}
    return metrics, extra, view.breakdown()


def result(correct: bool, attempted: int, failed: int,
           metrics: dict, device: dict, checks: dict,
           breakdown: dict | None = None) -> dict:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def say(*parts) -> None:
    print("port_bench:", *parts, file=sys.stderr, flush=True)


def judged(numbers: dict, limits: dict) -> dict:
    """{name: (value, limit)}; a number without a limit is held to 0."""
    return {k: (float(v), float(limits.get(k, 0.0)))
            for k, v in numbers.items()}


def all_within(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
