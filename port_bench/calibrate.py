"""The readings a cell's limits are set from, on the card, in one process:

    python port_bench/calibrate.py --workload W --seeds 1,2,... \
        --control-seeds 7,8,9 [--faults serve.altered,...] --seconds 3

For each seed of --seeds, one run of the cell (a --seconds window) gives
the program's numbers; for each seed of --control-seeds, the reference in
the next precision below the configuration's (float8 e4m3 for bfloat16,
port_bench/reference/ops.py) is put in the program's place and judged as
the program is; for each fault of --faults (port_bench/harness/faults.py)
and each control seed, a run with that fault planted.  A training
cell's reference steps are worked out once a seed and precision and judge
every reading of that seed.  One JSON line a reading; the limits
themselves are written by hand into port_bench/limits/<workload>.json
with the readings in PERF.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")
sys.path.insert(0, str(ROOT))

# the next precision below the configuration's, for the model; the
# decode, float32 in the program, gets bfloat16
CONTROL = {"bfloat16": "float8_e4m3fn", "float32": "bfloat16"}
DECODE_CONTROL = "bfloat16"


def control_numbers(cell, seed: int) -> dict:
    """The reference in the lower precision, judged as the program is."""
    from port_bench.harness import measure, serve, traffic, train
    from port_bench.reference import ops

    low = CONTROL[cell.conf["compute_dtype"]]
    ops.f32_no_tf32()
    if cell.traffic["kind"] == "serve":
        mix = cell.traffic
        p = serve.draw_weights(cell, cell.device)
        _, pool = traffic.serve_images(mix, seed, cell.device)
        per = []
        for i in serve.check_indices(cell):
            batch = traffic.serve_batch(mix, pool, i)
            ref = serve.reference(cell, p, batch, cell.device)
            ctl = serve.reference(cell, p, batch, cell.device, low,
                                  DECODE_CONTROL)
            nums, extra = serve.numbers(cell, ctl, ref)
            per.append({**nums, "dets_missed": extra["dets_missed"]})
            del ref, ctl
        out = serve.worst(per)
    else:
        batches = traffic.train_batches(cell.traffic, seed,
                                        cell.cfg["tpu"]["max_gt"],
                                        cell.device)
        n = cell.traffic["check_steps"]
        ref = train.reference_steps(cell, batches, cell.device, n)
        ctl = train.reference_steps(cell, batches, cell.device, n, low)
        out = train.numbers(ctl, ref)
    measure.release()
    return out


def reuse_training_references() -> None:
    """The training reference of a (cell, seed, precision) once."""
    from port_bench.harness import train

    memo, work = {}, train.reference_steps

    def steps(cell, batches, device, n, precision=None):
        key = (cell.workload, cell.seed, n, precision)
        if key not in memo:
            memo[key] = work(cell, batches, device, n, precision)
        return memo[key]
    train.reference_steps = steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    from port_bench.harness import faults, main as hm, measure

    reuse_training_references()

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    def emit(kind, seed, res):
        print(json.dumps({"workload": args.workload, "reading": kind,
                          "seed": seed, **res}), flush=True)

    def program(seed):
        cell = hm.load_cell(ROOT, args.workload, seed, args.seconds, False,
                            time.perf_counter())
        res = hm.run_cell(cell)
        measure.release()
        return {"numbers": {k: v[0] for k, v in res["checks"].items()},
                "metrics": {k: v["value"] for k, v in res["metrics"].items()
                            if k != "setup_s"},
                "memory_peak_bytes": res["device"]["memory_peak_bytes"]}

    for seed in seeds(args.seeds):
        emit("program", seed, program(seed))
    for seed in seeds(args.control_seeds):
        cell = hm.load_cell(ROOT, args.workload, seed, args.seconds, False,
                            time.perf_counter())
        emit("control", seed, {"numbers": control_numbers(cell, seed)})
        for f in [x for x in args.faults.split(",") if x]:
            with faults.plant(f):
                emit(f, seed, program(seed))


if __name__ == "__main__":
    main()
