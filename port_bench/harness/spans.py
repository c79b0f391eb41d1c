"""Spans and call records from the benchmark's own wrappers, installed
around named callables of the program where the program looks them up,
in the traced run only.

A metric's reader lists what it wraps as WRAPS: (module, attribute path,
label, mode).  Mode "span": the call runs inside a profiler range named
"pb.<label>" and its host wall time is kept; mode "call": the shapes of
its tensor arguments and its other arguments are kept.  A target that is
not found (renamed) is skipped, and the readers that need it find nothing.
"""

from __future__ import annotations

import collections
import functools
import importlib
import time

import torch


class Recorder:
    def __init__(self):
        self.on = False
        self.spans = collections.defaultdict(list)  # label -> [seconds]
        self.calls = collections.defaultdict(list)  # label -> [args]


def _describe(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.element_size())
    if isinstance(x, (list, tuple)):
        return type(x)(_describe(v) for v in x)
    return x


def _wrap(fn, label, mode, rec):
    @functools.wraps(fn)
    def span(*args, **kwargs):
        if not rec.on:
            return fn(*args, **kwargs)
        with torch.profiler.record_function("pb." + label):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                rec.spans[label].append(time.perf_counter() - t)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if rec.on:
            rec.calls[label].append(([_describe(a) for a in args],
                                     {k: _describe(v)
                                      for k, v in kwargs.items()}))
        return fn(*args, **kwargs)

    return span if mode == "span" else call


def install(wraps, rec: Recorder):
    """Wrap each (module, attr path, label, mode) once -> undo()."""
    undo, seen = [], set()
    for module, path, label, mode in wraps:
        if (module, path) in seen:
            continue
        seen.add((module, path))
        try:
            owner = importlib.import_module(module)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            fn = getattr(owner, attr)
        except (ImportError, AttributeError):
            continue
        setattr(owner, attr, _wrap(fn, label, mode, rec))
        undo.append((owner, attr, fn))

    def restore():
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)

    return restore
