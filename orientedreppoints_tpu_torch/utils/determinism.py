"""Training steps that repeat bit for bit.

The JAX package's training step is one XLA program whose scatter-adds and
reductions run in a fixed order, so one seed gives the same parameters on
every run.  The port's step does the same under ``deterministic()``:
PyTorch's deterministic algorithms (an op without one raises),
cuDNN's deterministic algorithms without autotuning (benchmark mode picks
an algorithm by timing, so two runs may pick two), and cuBLAS with a fixed
workspace (PyTorch refuses a cuBLAS call in deterministic mode without
one).  The hand-written kernels sum in fixed orders of their own
(csrc/deform_sample_bwd.cu: the plain version's).
``parallel/train.make_train_step`` runs every step under it.
"""

from __future__ import annotations

import contextlib
import os

import torch

# CUBLAS_WORKSPACE_CONFIG's value when the caller set none: 8 buffers of
# 4 MiB, one of the two settings under which cuBLAS repeats its sums
CUBLAS_WORKSPACE = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """PyTorch's, cuDNN's and cuBLAS's deterministic settings for the
    duration, then the caller's again.  Uninitialised memory is not
    filled: the step reads none, and the fill would add a write to every
    allocation."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    fill = torch.utils.deterministic
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark, fill.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    fill.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
        torch.backends.cudnn.deterministic = old[2]
        torch.backends.cudnn.benchmark = old[3]
        fill.fill_uninitialized_memory = old[4]
