"""A configuration joins the benchmark by files alone.  In a temporary
root, a third configuration (the first one with its backbone narrowed by
its own reference module's tiny(): a shallower network of the same type,
at the published neck and head widths), a traffic mix, a limits file and
a workloads entry are added as data, and every test function of the
configurations and cells picks them up from that root's BENCHMARK.json.
And no test file, nor the reference's detector, names a configuration, a
cell or a backbone type."""

import json
import re
import shutil

import pytest

from port_bench.harness import faults
from port_bench.reference import detector
from port_bench.tests import test_port_bench_cells as cells
from port_bench.tests import test_port_bench_yardstick as yardstick
from port_bench.tests.tiny import BENCH, ROOT, make_root

CONFIG, CELL, MIX = "added_config", "added-serve", "added_mix"
FILE = f"{BENCH.name}/configs/{CONFIG}.json"


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """A root holding the benchmark's data and the added configuration."""
    root = tmp_path_factory.mktemp("added")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for d in ("configs", "traffic", "limits"):
        shutil.copytree(BENCH / d, root / BENCH.name / d)
    conf = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    detector.backbone_module(conf["config"]).tiny(conf["config"])
    cell = next(w for w in bench["workloads"]
                if w["name"] == cells.FIRST[0])
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    side = mix["canvas"]
    conf["flops_per_image"] = {"serve": {str(side): yardstick.count_flops(
        conf["config"], "serve", side)}}
    (root / FILE).write_text(json.dumps(conf))
    (root / BENCH.name / "traffic" / f"{MIX}.json").write_text(
        json.dumps(mix))
    shutil.copy(BENCH / "limits" / f"{cell['name']}.json",
                root / BENCH.name / "limits" / f"{CELL}.json")
    bench["configs"].append({"name": CONFIG, "source": "a test", "file": FILE,
                             "reduced": ["backbone"], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": MIX, "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tiny(added, tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("added_tiny"),
                     cells.TINY_LIMITS, src=added)


def test_the_added_configuration_has_its_frozen_count(added):
    counts = [c for c in yardstick.frozen_counts(added) if c[0] == FILE]
    assert len(counts) == 1
    yardstick.frozen_equals_count(added, *counts[0])
    yardstick.every_cell_counted(added)
    # the count is checked, not only found: one FLOP off fails
    conf = json.loads((added / FILE).read_text())
    kind, side = counts[0][1:]
    conf["flops_per_image"][kind][str(side)] += 1
    wrong = added / BENCH.name / "configs" / "off_by_one.json"
    wrong.write_text(json.dumps(conf))
    with pytest.raises(AssertionError):
        yardstick.frozen_equals_count(added, str(wrong.relative_to(added)),
                                      kind, side)


def test_the_added_configuration_names_every_state_dict_entry(added):
    assert cells.configs(added)[CONFIG] == added / FILE
    cells.names_every_entry(added / FILE)


def test_the_added_cell_agrees_with_the_reference(added, tiny):
    assert cells.kinds(added)[CELL] == "serve"
    cells.agrees(tiny, CELL)


@pytest.mark.parametrize("fault", faults.NAMES["serve"])
def test_a_planted_fault_in_the_added_cell_is_not_correct(tiny, fault):
    cells.fault_caught(tiny, CELL, fault)


def test_the_added_cell_control_is_not_correct(tiny):
    cells.control_caught(tiny, CELL)


def names_of_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {c["name"] for c in bench["configs"]}
    names |= {w["name"] for w in bench["workloads"]}
    names |= {json.loads((ROOT / c["file"]).read_text())
              ["config"]["model"]["backbone"]["type"]
              for c in bench["configs"]}
    return names


SCANNED = sorted(BENCH.glob("tests/*.py")) + [BENCH / "reference" /
                                              "detector.py"]
# the command test runs one real cell by name: its one example
EXAMPLE = re.compile(r'^ARGS = \["--workload", "[^"]+",')


@pytest.mark.parametrize("path", SCANNED, ids=lambda p: p.name)
def test_no_test_or_detector_line_names_a_configuration_cell_or_backbone(
        path):
    names = names_of_the_benchmark()
    found = [(i, n) for i, line in enumerate(path.read_text().splitlines(),
                                             1)
             for n in names if n in line and not EXAMPLE.match(line)]
    assert not found, found
