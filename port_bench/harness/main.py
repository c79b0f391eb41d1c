"""The command: find the cell by name, check the card, run the cell's
driver, check that no JAX module was loaded, print the result line."""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "orientedreppoints_tpu")


@dataclasses.dataclass
class Cell:
    """What a driver gets: the cell's names and files, and the run's
    arguments."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    chips: int
    cfg: dict  # the model configuration as run
    conf: dict  # its benchmark file (source, dtype, frozen FLOPs, ...)
    traffic: dict
    limits: dict
    per_layer: list  # the metric entries this cell reports
    end_to_end: list
    t_start: float
    device: str = "cuda"


def bench_dir() -> Path:
    return Path(__file__).resolve().parent.parent


def load_cell(root: Path, workload: str, seed: int, seconds: float,
              trace: bool, t_start: float, device: str = "cuda") -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    conf_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    conf = json.loads((root / conf_entry["file"]).read_text())
    base = root / bench_dir().name
    traffic = json.loads((base / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    limits_file = base / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() \
        else {}
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(workload=workload, seed=seed, seconds=seconds,
                trace=trace, chips=wl["chips"], cfg=conf["config"],
                conf=conf, traffic=traffic, limits=limits,
                per_layer=per_layer, end_to_end=e2e, t_start=t_start,
                device=device)


def load_metric(name: str):
    """The reader of one per-layer metric: port_bench/metrics/<name>.py."""
    path = bench_dir() / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_card(chips: int) -> str | None:
    """None if this machine has the cards the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs only on the card"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} visible")
    return None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell) -> dict:
    """The driver of the cell's kind of traffic -> the result dict (and
    'checks': {name: (value, limit)})."""
    driver = importlib.import_module(
        f"port_bench.harness.{cell.traffic['kind']}")
    return driver.run(cell)


def report(result: dict, checks: dict) -> None:
    """Each number compared beside its limit as the last lines of stderr;
    the result as the last line of stdout, the checks its last key."""
    result = dict(result)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, root: Path, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(root, args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start)
    why = check_card(cell.chips)
    if why:
        print(f"port_bench: {why}", file=sys.stderr)
        return 2
    result = run_cell(cell)
    checks = result.pop("checks")
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    report(result, checks)
    return 0
