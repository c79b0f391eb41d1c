"""The profiler over the traced window, and its trace reduced to what
the per-layer readers ask: the program's own spans, device time of
kernels by name, the busy union, and the breakdown.

The trace is torch.profiler's (CUPTI) Chrome trace, written to TMPDIR,
read back and deleted.  The window is the benchmark's one range,
"pb.window"; the spans are the ranges the program opens itself through
utils/profiling.annotate (named "orp.*", listed in utils/profiling.SPANS).
A device event (kernel, memcpy, memset) belongs to the spans in which its
launch (the runtime call of the same correlation id) happened;
program_spans.py reads them.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_GAP_US = 10.0  # idle gaps shorter than this are launch spacing
WINDOW = "pb.window"
PREFIX = "orp."


@contextlib.contextmanager
def profiled(view_box: list):
    """Profile the block; on exit view_box gets [TraceView]."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        with torch.profiler.record_function(WINDOW):
            yield
    finally:
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    view_box.append(TraceView(events))


def short_name(name: str) -> str:
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, 1)[0][:80]


class TraceView:
    """The window's device events (device: (start, end, name,
    correlation), sorted; device_cats: each one's trace category;
    launch_ts: each one's launch time), the program's spans inside the
    window (program: name -> [(start, end)]) and the host's ops."""

    def __init__(self, events):
        device, launches, program, ops = [], {}, {}, []
        self.t0, self.t1 = 0.0, float("inf")
        for e in events:
            cat, ph = e.get("cat", ""), e.get("ph")
            if ph != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args", {})
            if cat in _DEVICE_CATS:
                device.append((ts, ts + dur, e["name"],
                               args.get("correlation"), cat))
            elif cat in ("cuda_runtime", "cuda_driver"):
                launches[args.get("correlation")] = ts
            elif cat == "user_annotation" and e["name"] == WINDOW:
                self.t0, self.t1 = ts, ts + dur
            elif cat == "user_annotation" and e["name"].startswith(PREFIX):
                program.setdefault(e["name"], []).append((ts, ts + dur))
            elif cat == "cpu_op":
                ops.append((ts, ts + dur, e["name"]))
        device = sorted(d for d in device
                        if d[1] > self.t0 and d[0] < self.t1)
        self.device = [d[:4] for d in device]
        self.device_cats = [d[4] for d in device]
        self.launch_ts = [launches.get(d[3]) for d in self.device]
        self.program = {}
        for name, rs in program.items():
            rs = [r for r in rs if r[1] > self.t0 and r[0] < self.t1]
            if rs:
                self.program[name] = rs
        ops.sort()
        self._ops = ops
        self._op_starts = [o[0] for o in ops]
        self._spans = sorted((a, b, k) for k, rs in self.program.items()
                             for a, b in rs)
        self._span_starts = [s[0] for s in self._spans]

    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_s(self) -> float:
        """Length of the union of device intervals inside the window."""
        total, end = 0.0, self.t0
        for a, b, _, _ in self.device:
            a, b = max(a, end, self.t0), min(b, self.t1)
            if b > a:
                total += b - a
                end = b
        return total * 1e-6

    def _innermost(self, starts, items, ts, depth=64):
        i = bisect.bisect_right(starts, ts) - 1
        for j in range(i, max(-1, i - depth), -1):
            if items[j][0] <= ts <= items[j][1]:
                return items[j][2]
        return None

    def span_of(self, ts):
        """The innermost program span open at host time ts, or None."""
        return None if ts is None else self._innermost(
            self._span_starts, self._spans, ts)

    def kernel_s(self, patterns) -> float:
        return sum(b - a for a, b, name, _ in self.device
                   if any(p in name for p in patterns)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time and the longest idle gaps,
        each keyed by the innermost program span its launch fell in
        ("-": none) and the op's name (a gap: the host op running when
        the work that ends it was launched)."""
        ops = {}
        for (a, b, name, _), ts in zip(self.device, self.launch_ts):
            key = f"{self.span_of(ts) or '-'}:{short_name(name)}"
            ops[key] = ops.get(key, 0.0) + (b - a) * 1e-6
        gaps, end = {}, self.t0
        for (a, b, _, _), ts in zip(self.device, self.launch_ts):
            if a - end > _GAP_US:
                op = None if ts is None else self._innermost(
                    self._op_starts, self._ops, ts)
                key = f"{self.span_of(ts) or '-'}:{op or 'host'}"
                gaps[key] = gaps.get(key, 0.0) + (a - end) * 1e-6
            end = max(end, b)
        if self.t1 - end > _GAP_US:
            gaps["-:after last device op"] = (self.t1 - end) * 1e-6
        return {k: sorted(v.items(), key=lambda kv: -kv[1])[:top]
                for k, v in (("device_ops", ops), ("idle_gaps", gaps))}
