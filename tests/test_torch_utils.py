"""The port's environment report and profiling utilities
(utils/collect_env.py, utils/profiling.py) beside the JAX package's, on
the CPU: the same report layout ('key: value' lines), the same
'[profile] name: X ms' log line, a trace with the annotated ranges, and
no JAX in the port's modules."""

import json
import logging
import os
import re

import jax.numpy as jnp
import pytest
import torch

from orientedreppoints_tpu.utils import collect_env as ref_collect_env
from orientedreppoints_tpu.utils import env_info_str as ref_env_info_str
from orientedreppoints_tpu.utils import profiling as prof_ref
from orientedreppoints_tpu_torch.ops import _ext
from orientedreppoints_tpu_torch.utils import collect_env, profiling

PROFILE_LINE = re.compile(r"^\[profile\] (\S+): [0-9]+\.[0-9]{2} ms$")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_collect_env_reports_the_torch_stack():
    env = collect_env.collect_env()
    for key in ("sys.platform", "Python", "PyTorch", "torch.version.cuda",
                "cuDNN", "GPU count", "NVCC", "GCC", "numpy", "scipy",
                "OrientedRepPoints-torch", "Kernel library built"):
        assert key in env, key
    assert env["PyTorch"] == torch.__version__
    assert env["GPU count"] == (torch.cuda.device_count()
                                if torch.cuda.is_available() else 0)
    # read, never built: the flag follows the build directory
    assert env["Kernel library built"] == (_ext.built_path() is not None)
    assert not any(k.startswith(("JAX", "jax", "flax")) for k in env)
    assert env["Python"] == ref_collect_env()["Python"]


def test_env_info_str_layout_as_jax():
    lines = collect_env.env_info_str().splitlines()
    ref = ref_env_info_str().splitlines()
    pattern = re.compile(r"^[^:]+: .*$")
    assert all(pattern.match(ln) for ln in lines + ref)
    assert lines[:2] == ref[:2]  # sys.platform, Python


def _records(name, fn):
    got = []
    handler = logging.Handler()
    handler.emit = lambda r: got.append(r.getMessage())
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        fn(logger)
    finally:
        logger.removeHandler(handler)
    return got


def test_profile_time_logs_the_jax_line():
    x = torch.arange(6.0)

    def port(logger):
        with profiling.profile_time("mm", stream=[x, {"a": (x, 1)}],
                                    logger=logger):
            x @ x

    def ref(logger):
        y = jnp.arange(6.0)
        with prof_ref.profile_time("mm", stream=y, logger=logger):
            y @ y

    got, want = _records("port_profile", port), _records("ref_profile", ref)
    assert len(got) == len(want) == 1
    assert PROFILE_LINE.match(got[0]) and PROFILE_LINE.match(want[0])
    assert got[0].split(":")[0] == want[0].split(":")[0] == "[profile] mm"


def test_profile_time_logs_when_the_block_raises():
    def port(logger):
        with pytest.raises(ValueError):
            with profiling.profile_time("boom", logger=logger):
                raise ValueError("x")

    (line,) = _records("port_profile_raise", port)
    assert PROFILE_LINE.match(line)


def test_trace_holds_the_annotated_ranges(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("orp_forward"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        with profiling.annotate("orp_decode"):
            torch.ones(4).sum()
    assert prof is not None
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"orp_forward", "orp_decode"} <= names
    # outside a trace, annotate is a no-op range
    with profiling.annotate("idle"):
        pass
