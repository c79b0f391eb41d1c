"""The harness end to end at a tiny size on the CPU: the port against the
reference (one serving batch, or the check steps of one trainer, of each
configuration) comes out correct, and every planted fault and the control
come out not correct."""

import time

import pytest
import torch

from port_bench import calibrate
from port_bench.harness import faults, main
from port_bench.reference import detector
from port_bench.tests.tiny import make_root

# limits for the tiny float32 cells: the program reads ~3e-6 (heads),
# ~1e-7 (losses), ~3e-5 (leaf norms); the bfloat16 control 2e-2, 5e-2,
# 6e-2 and above
TINY_LIMITS = {"canvas_max_abs": 0.0, "head_rel_l2": 1e-3,
               "decode_unmatched": 0.0,
               "loss_rel_gap": 1e-4, "loss_term_gap": 1e-3,
               "grad_leaf_gap": 1e-2, "change_leaf_gap": 1e-2}
CELLS = ["r50-serve-dense", "swin_t-serve-dense", "r50-train-b16",
         "swin_t-train-b8"]
SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return make_root(tmp_path_factory.mktemp("tiny"), TINY_LIMITS)


def run(root, workload, trace=False, seed=SEED):
    cell = main.load_cell(root, workload, seed, 0.2, trace,
                          time.perf_counter(), device="cpu")
    return cell, main.run_cell(cell)


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(root, workload):
    _, res = run(root, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("workload", ["r50-serve-dense", "r50-train-b16"])
def test_traced_run_reports_per_layer_metrics(root, workload):
    _, res = run(root, workload, trace=True)
    assert res["correct"], res["checks"]
    names = set(res["metrics"])
    assert names and not names & {"serve_images_per_s", "train_images_per_s",
                                  "setup_s"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS
    for f in faults.NAMES["serve" if "serve" in w else "train"]])
def test_a_planted_fault_is_not_correct(root, workload, fault):
    with faults.plant(fault):
        _, res = run(root, workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(root, workload):
    cell = main.load_cell(root, workload, SEED, 0.2, False,
                          time.perf_counter(), device="cpu")
    nums = calibrate.control_numbers(cell, SEED)
    assert any(v > TINY_LIMITS[k] for k, v in nums.items()
               if k in TINY_LIMITS), nums


@pytest.mark.parametrize("name", ["orientedreppoints_r50",
                                  "orientedreppoints_swin_tiny"])
def test_reference_names_every_entry_of_the_ports_state_dict(name):
    import json

    from orientedreppoints_tpu_torch.apis import build_detector

    from port_bench.tests.tiny import BENCH

    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = cfg["config"]
    with torch.device("meta"):
        model = build_detector(cfg, "float32")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {n: tuple(s) for n, s, _ in detector.spec(cfg)}
    assert got == want


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
                _, res = run(root, "r50-train-b16")
            assert not res["correct"], res["checks"]
        else:
            _, res = run(root, "r50-train-b16")
            assert res["correct"], res["checks"]
    assert len(worked) == 1
