"""The harness end to end at a tiny size on the CPU: the port against the
reference (one serving batch, or the check steps of one trainer, of each
configuration) comes out correct, and every planted fault and the control
come out not correct."""

import json
import time
from pathlib import Path

import pytest
import torch

from port_bench import calibrate
from port_bench.harness import faults, main
from port_bench.reference import detector
from port_bench.tests.tiny import BENCH, ROOT, make_root

# limits for the tiny float32 cells: the program reads ~3e-6 (heads),
# ~1e-7 (losses), ~3e-5 (leaf norms); the bfloat16 control 2e-2, 5e-2,
# 6e-2 and above
TINY_LIMITS = {"canvas_max_abs": 0.0, "head_rel_l2": 1e-3,
               "decode_unmatched": 0.0,
               "loss_rel_gap": 1e-4, "loss_term_gap": 1e-3,
               "grad_leaf_gap": 1e-2, "change_leaf_gap": 1e-2}
SEED = 2 ** 31 + 11


def kinds(root: Path = ROOT) -> dict:
    """{cell: its mix's kind} of every cell of root/BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return {w["name"]: json.loads(
        (root / BENCH.name / "traffic" / f"{w['traffic']}.json")
        .read_text())["kind"] for w in bench["workloads"]}


def configs(root: Path = ROOT) -> dict:
    """{configuration: its file} of root/BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return {c["name"]: root / c["file"] for c in bench["configs"]}


CELLS = list(kinds())
FIRST = [next(w for w, k in kinds().items() if k == kind)
         for kind in ("serve", "train")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return make_root(tmp_path_factory.mktemp("tiny"), TINY_LIMITS)


def run(root, workload, trace=False, seed=SEED):
    cell = main.load_cell(root, workload, seed, 0.2, trace,
                          time.perf_counter(), device="cpu")
    return cell, main.run_cell(cell)


def agrees(root, workload):
    _, res = run(root, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]


def fault_caught(root, workload, fault):
    with faults.plant(fault):
        _, res = run(root, workload)
    assert not res["correct"], res["checks"]


def control_caught(root, workload):
    cell = main.load_cell(root, workload, SEED, 0.2, False,
                          time.perf_counter(), device="cpu")
    nums = calibrate.control_numbers(cell, SEED)
    assert any(v > TINY_LIMITS[k] for k, v in nums.items()
               if k in TINY_LIMITS), nums


def names_every_entry(conf_file: Path):
    from orientedreppoints_tpu_torch.apis import build_detector

    cfg = json.loads(conf_file.read_text())["config"]
    with torch.device("meta"):
        model = build_detector(cfg, "float32")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {n: tuple(s) for n, s, _ in detector.spec(cfg)}
    assert got == want


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(root, workload):
    agrees(root, workload)


@pytest.mark.parametrize("workload", FIRST)
def test_traced_run_reports_per_layer_metrics(root, workload):
    _, res = run(root, workload, trace=True)
    assert res["correct"], res["checks"]
    names = set(res["metrics"])
    assert names and not names & {"serve_images_per_s", "train_images_per_s",
                                  "setup_s"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, kind in kinds().items() for f in faults.NAMES[kind]])
def test_a_planted_fault_is_not_correct(root, workload, fault):
    fault_caught(root, workload, fault)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(root, workload):
    control_caught(root, workload)


@pytest.mark.parametrize("name", list(configs()))
def test_reference_names_every_entry_of_the_ports_state_dict(name):
    names_every_entry(configs()[name])


def test_calibration_works_out_each_training_reference_once(root,
                                                            monkeypatch):
    from port_bench.harness import train

    worked = []
    work = train.reference_steps

    def counted(*args, **kwargs):
        worked.append(1)
        return work(*args, **kwargs)
    monkeypatch.setattr(train, "reference_steps", counted)
    calibrate.reuse_training_references()
    for fault in (None, "train.altered"):
        if fault:
            with faults.plant(fault):
                _, res = run(root, FIRST[1])
            assert not res["correct"], res["checks"]
        else:
            _, res = run(root, FIRST[1])
            assert res["correct"], res["checks"]
    assert len(worked) == 1
