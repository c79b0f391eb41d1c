"""Environment report logged at the start of training (counterpart of
utils/collect_env.py, after the reference's mmdet/utils/collect_env.py):
the platform, Python, torch with its CUDA and cuDNN, each card, nvcc, GCC,
numpy, scipy and this package, and whether the kernel library of
ops/_ext.py is built for the current sources (it is not built here)."""

from __future__ import annotations

import importlib
import subprocess
import sys

import torch


def _first_line(cmd: list[str]) -> str:
    """The first line of a command's output, or 'n/a'."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=10,
                             check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "n/a"
    return out.strip().splitlines()[0] if out.strip() else "n/a"


def _nvcc_version() -> str:
    from ..ops import _ext

    try:
        nvcc = _ext._nvcc()
    except RuntimeError:
        return "not found"
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return f"{nvcc}: n/a"
    release = [ln for ln in out.splitlines() if "release" in ln]
    return f"{nvcc}: {(release or ['unknown'])[-1].strip()}"


def collect_env() -> dict:
    from .. import __version__
    from ..ops import _ext

    env = {"sys.platform": sys.platform,
           "Python": sys.version.replace("\n", ""),
           "PyTorch": torch.__version__,
           "torch.version.cuda": torch.version.cuda,
           "cuDNN": torch.backends.cudnn.version()
           if torch.backends.cudnn.is_available() else None}
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    env["CUDA available"] = count > 0
    for i in range(count):
        major, minor = torch.cuda.get_device_capability(i)
        env[f"GPU {i}"] = (f"{torch.cuda.get_device_name(i)} "
                           f"(sm_{major}{minor})")
    env["GPU count"] = count
    env["NVCC"] = _nvcc_version()
    env["GCC"] = _first_line(["gcc", "--version"])
    for mod in ("numpy", "scipy"):
        try:
            env[mod] = importlib.import_module(mod).__version__
        except ImportError:
            env[mod] = "not installed"
    env["OrientedRepPoints-torch"] = __version__
    env["Kernel library built"] = _ext.built_path() is not None
    return env


def env_info_str() -> str:
    return "\n".join(f"{k}: {v}" for k, v in collect_env().items())
