#!/usr/bin/env python
"""Run several quality runs of tools/synth_benchmark_torch.py side by side
on one card and gather what each printed.

    python3 tools/quality_runs_torch.py --out work_dirs/quality/out \\
        --timeout 3420 synth_swin_512_hard_aug synth_r18_512_hard_aug

Each NAME is a config of configs/dota/ trained on the hard benchmark with
the hard-aug recipe and scored with (0.5, 1.0, 1.5) x flip TTA
(``--hard --train --flip_tta --ms_tta 0.5,1.0,1.5``) in its own work dir
under work_dirs/quality/ and its own process, started together (two
side by side fit one 3,600 s call on one H100 host; three did not).
``synth_r50_1024_hard_aug`` runs at the JAX
package's geometry (2048^2 scenes, 1024^2 tiles at gap 200) for
--steps timed steps (its full schedule does not fit a call), then scores
those weights on 2 val scenes without TTA (a check that the path runs,
not a quality number).  Each run is killed at --timeout seconds.

Writes OUT/NAME.log (the tool's output), OUT/NAME.json (its last JSON
line, its exit code and seconds) and OUT/gpu.csv (nvidia-smi every 30 s:
utilisation, memory, power); prints one summary line a run.  The runs
share the host's cores and the card, so their wall times and loader
waits are those of runs side by side, not of a run alone.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import time

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TTA = ["--flip_tta", "--ms_tta", "0.5,1.0,1.5"]
# per config: the tool's arguments beside --config --hard --train
EXTRA = {"synth_r50_1024_hard_aug": ["--scene_size", "2048", "--subsize",
                                     "1024", "--gap", "200",
                                     "--val_scenes", "2"]}


def command(name: str, work_dir: str, steps: int) -> list:
    cmd = [sys.executable, osp.join(ROOT, "tools", "synth_benchmark_torch.py"),
           "--config", osp.join("configs", "dota", name + ".py"), "--hard",
           "--train", "--work_dir", work_dir, *EXTRA.get(name, [])]
    if name in EXTRA:
        return cmd + ["--max_steps", str(steps), "--log_interval", "10"]
    return cmd + TTA


def last_json(text: str):
    for line in reversed(text.splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="+", help="configs of configs/dota/")
    p.add_argument("--out", default=osp.join("work_dirs", "quality", "out"))
    p.add_argument("--timeout", type=float, default=3300.0)
    p.add_argument("--steps", type=int, default=200,
                   help="timed steps of synth_r50_1024_hard_aug")
    p.add_argument("--threads", type=int, default=2,
                   help="OMP_NUM_THREADS of each run")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS=str(args.threads))
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu,memory.used,"
         "power.draw,power.limit", "--format=csv", "-l", "30"],
        stdout=open(osp.join(args.out, "gpu.csv"), "w"),
        stderr=subprocess.DEVNULL)
    runs = []
    for name in args.names:
        cmd = command(name, osp.join("work_dirs", "quality", name),
                      args.steps)
        log = open(osp.join(args.out, name + ".log"), "w")
        runs.append((name, log, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    # each run's exit code and seconds as it ends (killed at the timeout)
    ended = {}
    while len(ended) < len(runs):
        for name, _, t0, proc in runs:
            if name in ended:
                continue
            if proc.poll() is not None:
                ended[name] = (proc.returncode, time.perf_counter() - t0)
            elif time.perf_counter() - t0 > args.timeout:
                proc.kill()
                proc.wait()
                ended[name] = (124, time.perf_counter() - t0)
        time.sleep(1.0)
    rc_all = 0
    for name, log, _, _ in runs:
        rc, seconds = ended[name]
        log.close()
        with open(osp.join(args.out, name + ".log")) as f:
            result = last_json(f.read())
        out = dict(name=name, rc=rc, seconds=seconds, result=result)
        with open(osp.join(args.out, name + ".json"), "w") as f:
            json.dump(out, f, indent=2)
        keep = ("mAP", "mAOE_deg", "mAOE_mod90_deg", "tta_mAP_delta")
        print(json.dumps(dict(name=name, rc=rc, seconds=out["seconds"],
                              **{k: (result or {}).get(k) for k in keep},
                              train=(result or {}).get("train"))),
              flush=True)
        # the tool exits 1 when mAP <= 0.6 (its gate); a cut run has 124
        rc_all = rc_all or rc
    smi.terminate()
    smi.wait()
    return rc_all


if __name__ == "__main__":
    sys.exit(main())
