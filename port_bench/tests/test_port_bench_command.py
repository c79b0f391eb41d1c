"""The command without a card, the command in a directory that holds only
the benchmark, and the benchmark's imports."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.tests.tiny import BENCH, ROOT

ARGS = ["--workload", "r50-serve-dense", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_fails_and_prints_no_result():
    p = run(ROOT)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not p.stdout.strip()


def test_the_benchmark_alone_fails(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for path in bench["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
               p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_import(path):
    names = set(top_level_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "orientedreppoints_tpu"}
    if "reference" in path.relative_to(BENCH).parts:
        assert "orientedreppoints_tpu_torch" not in names
        assert not names & {"port_bench"}  # nothing outside the reference
