"""Call records from the benchmark's own wrappers, installed around named
launchers of the program where the program looks them up, in the traced
run only: the roofline readers work out each launch's least time from the
shapes of its arguments.

A metric's reader lists what it wraps as WRAPS: (module, attribute path,
label, names of the arguments read by value).  While the recorder is on,
each call's tensor arguments are kept as ("tensor", shape, element
size), those named to be read by value (a count an image) as ("values",
tensor), and its other arguments as given.  A target that is not found
(renamed) is skipped, and the readers that need it find nothing.
"""

from __future__ import annotations

import collections
import functools
import importlib
import inspect

import torch


class Recorder:
    def __init__(self):
        self.on = False
        self.calls = collections.defaultdict(list)  # label -> [args]


def _describe(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.element_size())
    if isinstance(x, (list, tuple)):
        return type(x)(_describe(v) for v in x)
    return x


def _wrap(fn, label, rec, by_value=()):
    names = list(inspect.signature(fn).parameters)
    at = {names.index(n) for n in by_value}

    def keep(x, value):
        # by value: the tensor itself, read once the window has closed (a
        # copy would add a launch, and reading it now a synchronize)
        return ("values", x) if value else _describe(x)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if rec.on:
            rec.calls[label].append(
                ([keep(a, i in at) for i, a in enumerate(args)],
                 {k: keep(v, k in by_value) for k, v in kwargs.items()}))
        return fn(*args, **kwargs)

    return call


def install(wraps, rec: Recorder):
    """Wrap each (module, attr path, label, by value) once -> undo()."""
    undo, seen = [], set()
    for module, path, label, by_value in wraps:
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
        if not set(by_value) <= set(inspect.signature(fn).parameters):
            continue  # an argument renamed: skipped as a missing target
        setattr(owner, attr, _wrap(fn, label, rec, by_value))
        undo.append((owner, attr, fn))

    def restore():
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)

    return restore
