"""The Slurm launchers of the PyTorch port (tools/slurm_test_torch.sh,
tools/slurm_train_torch.sh) under stub ``srun``, ``scontrol`` and
``python3`` scripts on PATH: srun runs the task script once a task with
Slurm's task variables set, and python3 records its arguments and the
ORP_* environment it was given."""

import json
import os
import stat
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# srun: record its own arguments, then run `bash -c SCRIPT` (its last two
# arguments) once for each of --ntasks tasks, --ntasks-per-node a node
SRUN = r"""#!/usr/bin/env bash
printf '%s\n' "$@" > "$STUB_DIR/srun_args"
ntasks=1; per_node=1
for a in "$@"; do
  case "$a" in
    --ntasks=*) ntasks=${a#--ntasks=} ;;
    --ntasks-per-node=*) per_node=${a#--ntasks-per-node=} ;;
  esac
done
script="${@: -1}"
for ((t = 0; t < ntasks; t++)); do
  SLURM_JOB_NODELIST="node[01-02]" SLURM_NTASKS=$ntasks SLURM_PROCID=$t \
    SLURM_LOCALID=$((t % per_node)) bash -c "$script" || exit $?
done
"""
SCONTROL = """#!/usr/bin/env bash
[ "$1 $2 $3" = "show hostnames node[01-02]" ] || exit 9
printf 'node01\\nnode02\\n'
"""
# python3: one JSON line a call with its argv and the env the task gave it
PYTHON = f"""#!{sys.executable}
import json, os, sys
keys = ("ORP_COORDINATOR_ADDRESS", "ORP_NUM_PROCESSES", "ORP_PROCESS_ID",
        "ORP_LOCAL_RANK", "CUDA_VISIBLE_DEVICES", "OMP_NUM_THREADS")
with open(os.path.join(os.environ["STUB_DIR"], "calls"), "a") as f:
    f.write(json.dumps(dict(argv=sys.argv[1:],
                            env={{k: os.environ.get(k) for k in keys}}))
            + "\\n")
"""


@pytest.fixture
def stubs(tmp_path):
    for name, text in (("srun", SRUN), ("scontrol", SCONTROL),
                       ("python3", PYTHON)):
        path = tmp_path / name
        path.write_text(text)
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, STUB_DIR=str(tmp_path),
               PATH=f"{tmp_path}{os.pathsep}{os.environ['PATH']}",
               GPUS_PER_NODE="2")
    for name in ("CUDA_VISIBLE_DEVICES", "OMP_NUM_THREADS", "PY_ARGS",
                 "COORD_PORT", "SRUN_ARGS"):
        env.pop(name, None)
    return tmp_path, env


def calls(stub_dir):
    with open(stub_dir / "calls") as f:
        return [json.loads(line) for line in f]


def test_slurm_test_runs_a_task_a_card(stubs):
    stub_dir, env = stubs
    env["PY_ARGS"] = "--format_task1 out/task1_{rank} --batch_size 2"
    res = subprocess.run(
        ["bash", os.path.join(REPO, "tools", "slurm_test_torch.sh"), "part",
         "job", "configs/dota/orientedreppoints_r50_demo.py", "w/epoch_12.pt",
         "4"], env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    srun = (stub_dir / "srun_args").read_text().splitlines()
    for want in ("-p", "part", "--job-name=job", "--gres=gpu:2",
                 "--ntasks=4", "--ntasks-per-node=2", "--kill-on-bad-exit=1"):
        assert want in srun
    got = calls(stub_dir)
    assert len(got) == 4
    for rank, call in enumerate(got):
        assert call["argv"] == [
            "-u", os.path.join(REPO, "tools", "test_torch.py"),
            "configs/dota/orientedreppoints_r50_demo.py", "--checkpoint",
            "w/epoch_12.pt", "--format_task1", f"out/task1_{rank}",
            "--batch_size", "2"]
        assert call["env"] == {
            "ORP_COORDINATOR_ADDRESS": "node01:29500",
            "ORP_NUM_PROCESSES": "4", "ORP_PROCESS_ID": str(rank),
            "ORP_LOCAL_RANK": str(rank % 2),
            "CUDA_VISIBLE_DEVICES": str(rank % 2), "OMP_NUM_THREADS": "1"}


def test_slurm_test_and_train_map_slurm_alike(stubs):
    """Both launchers give a task the same ORP_* contract (the port's
    parallel/dist.py reads it), the test one without PY_ARGS adding
    nothing after the checkpoint."""
    stub_dir, env = stubs
    env["COORD_PORT"] = "12345"
    cfg = "configs/dota/synth_r18_512.py"
    for script, last in (("slurm_test_torch.sh", "ckpt.pt"),
                         ("slurm_train_torch.sh", "wd")):
        res = subprocess.run(["bash", os.path.join(REPO, "tools", script),
                              "p", "j", cfg, last, "2"], env=env,
                             capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stderr
    test_calls, train_calls = calls(stub_dir)[:2], calls(stub_dir)[2:]

    def orp(call):
        return {k: v for k, v in call["env"].items() if k.startswith("ORP_")}

    assert [orp(c) for c in test_calls] == [orp(c) for c in train_calls]
    # the test task sees its card only; the train task picks it by rank
    assert [c["env"]["CUDA_VISIBLE_DEVICES"] for c in test_calls] == [
        "0", "1"]
    assert all(c["env"]["CUDA_VISIBLE_DEVICES"] is None
               for c in train_calls)
    assert test_calls[1]["env"]["ORP_COORDINATOR_ADDRESS"] == "node01:12345"
    assert test_calls[0]["argv"][-2:] == ["--checkpoint", "ckpt.pt"]
    assert train_calls[0]["argv"][-2:] == ["--work_dir=wd", "--validate"]
