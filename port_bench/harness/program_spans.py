"""Readings of the program's own spans in the traced window: the ranges
it opens itself through utils/profiling.annotate (named "orp.*", listed in
utils/profiling.SPANS), which trace.TraceView keeps as `program`.

Readings under a span name (every range of that name; None: every
program span), in seconds:

  host_s    inside its ranges, on the trace's host clock;
  device_s  of the device events whose launch falls inside them;
  launches  kernel events (no memcpy or memset) launched inside them;
  idle_s    of the device's idle gaps longer than trace._GAP_US that end
            in an event launched inside them (TraceView.breakdown's gap
            rule; the window's tail after its last device op ends in no
            event, so no span owns it).

A program without the span (the parent of the change that added it)
leaves nothing to read: the per-step helpers return None.
"""

from __future__ import annotations

import bisect

from . import trace


def _union(view, name):
    """The ranges of span `name` (None: of every program span) merged
    into disjoint sorted intervals."""
    rs = sorted(r for k, v in view.program.items()
                if name is None or k == name for r in v)
    out = []
    for a, b in rs:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(union, starts, ts) -> bool:
    if ts is None:
        return False
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= union[i][1]


def _launched(view, name):
    """Per event of view.device: whether its launch lies inside the
    span's ranges."""
    union = _union(view, name)
    starts = [a for a, _ in union]
    return [_inside(union, starts, ts) for ts in view.launch_ts]


def host_s(view, name) -> float:
    return sum(b - a for a, b in _union(view, name)) * 1e-6


def device_s(view, name) -> float:
    return sum(b - a for (a, b, _, _), inside in
               zip(view.device, _launched(view, name)) if inside) * 1e-6


def launches(view, name) -> int:
    return sum(1 for cat, inside in zip(view.device_cats,
                                        _launched(view, name))
               if inside and cat == "kernel")


def gaps(view):
    """(seconds, index of the device event that ends it) of each idle
    gap longer than trace._GAP_US inside the window, as breakdown finds
    them."""
    out, end = [], view.t0
    for i, (a, b, _, _) in enumerate(view.device):
        if a - end > trace._GAP_US:
            out.append(((a - end) * 1e-6, i))
        end = max(end, b)
    return out


def idle_s(view, name) -> float:
    inside = _launched(view, name)
    return sum(s for s, i in gaps(view) if inside[i])


def per_step(run, reading, name, scale: float = 1.0):
    """reading(view, name) * scale a batch or step of the run; None when
    the trace holds no range of the span."""
    if not run.view.program.get(name):
        return None
    return scale * reading(run.view, name) / run.steps
