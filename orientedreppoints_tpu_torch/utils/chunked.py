"""A long run that re-executes itself when its host memory grows
(counterpart of utils/chunked.py).

Any long run whose resident set grows epoch by epoch (a cache that fills,
a leak in a library, allocator fragmentation) can outgrow its host.  At
an epoch boundary the trainer checks its resident set size and, past a
threshold, checkpoints and re-executes itself (os.execv: the same pid, a
fresh address space) with the flags that resume it, so a run of many
epochs stays one command.  The checkpoint written at each epoch (or the
caller's save_fn) is what the new process resumes from.

Bounded by construction: callers re-exec only when an epoch was completed
in this process and more remain, so a run re-execs at most once an epoch
even when the threshold lies below the baseline RSS.  Stdlib only.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Iterable

__all__ = ["current_rss_gb", "argv_with_flags", "maybe_reexec"]


def current_rss_gb() -> float:
    """Current (not peak) resident set size in GB, from /proc/self/status;
    ru_maxrss (a high-water mark, which survives os.execv) where /proc is
    missing."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1e6  # kB -> GB
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def argv_with_flags(
    argv: list[str],
    ensure: Iterable[str] = (),
    ensure_kv: dict[str, str] | None = None,
) -> list[str]:
    """argv for the resumed process: append each bare flag in `ensure`
    if absent; set or replace each `--flag value` pair in `ensure_kv`."""
    out = list(argv)
    for flag in ensure:
        if flag not in out:
            out.append(flag)
    for flag, value in (ensure_kv or {}).items():
        if flag in out:
            i = out.index(flag)
            if i + 1 < len(out):
                out[i + 1] = value
            else:
                out.append(value)
        else:
            out += [flag, value]
    return out


def maybe_reexec(
    rss_limit_gb: float,
    save_fn: Callable[[], None],
    build_argv: Callable[[list[str]], list[str]],
    log: Callable[[str], None] = print,
) -> None:
    """At an epoch boundary: if RSS >= rss_limit_gb, checkpoint through
    save_fn() and replace this process with the resumed invocation
    build_argv(sys.argv).

    Never returns when the threshold is crossed (os.execv).  Callers call
    this only while epochs remain, so the last chunk's evaluation runs in
    process.  rss_limit_gb <= 0 disables the check."""
    if not rss_limit_gb or rss_limit_gb <= 0:
        return
    rss = current_rss_gb()
    if rss < rss_limit_gb:
        return
    save_fn()
    argv = build_argv(list(sys.argv))
    log(
        f"[chunked] host RSS {rss:.1f}G >= {rss_limit_gb:g}G; "
        f"checkpointed, re-exec: {' '.join(argv)}"
    )
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(sys.executable, [sys.executable] + argv)
