"""Start the processes of one data-parallel group of the PyTorch port on
this host and wait for them (the ORP_* env contract of
orientedreppoints_tpu_torch/parallel/dist.py, as tools/dist_train_torch.sh
sets it), with every rank's output captured:

    from tools.launch_torch import launch_local
    outs = launch_local([sys.executable, "script.py"], 2, timeout=600)

The test suite, chip_smoke.py and tools/dryrun_ddp_torch.py start their
ranks through it.  Imports no torch.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local(argv: Sequence[str], nprocs: int, env: dict | None = None,
                 local_ranks: Sequence[int] | None = None,
                 timeout: float | None = None, cwd: str | None = None
                 ) -> list[str]:
    """Run argv as the nprocs processes of one group on this host: each
    gets the ORP_* contract (tcp://localhost on a free port, its rank,
    ORP_LOCAL_RANK from local_ranks, default its rank) and
    OMP_NUM_THREADS=1.  Waits for all and returns their stdout in rank
    order; raises if one fails or the timeout passes, after stopping the
    others (a rank left waiting in a collective never returns)."""
    base = dict(os.environ if env is None else env)
    port = free_port()
    ranks = list(range(nprocs)) if local_ranks is None else list(local_ranks)
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        try:
            for r in range(nprocs):
                out = open(os.path.join(tmp, f"{r}.out"), "w+")
                err = open(os.path.join(tmp, f"{r}.err"), "w+")
                logs.append((out, err))
                procs.append(subprocess.Popen(list(argv), cwd=cwd, env=dict(
                    base, ORP_COORDINATOR_ADDRESS=f"localhost:{port}",
                    ORP_NUM_PROCESSES=str(nprocs), ORP_PROCESS_ID=str(r),
                    ORP_LOCAL_RANK=str(ranks[r]), OMP_NUM_THREADS="1"),
                    stdout=out, stderr=err))
            deadline = None if timeout is None else time.monotonic() + timeout
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if deadline is not None and time.monotonic() > deadline:
                    failed = "timeout"
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    if failed is not None:
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n"
                          f"{o[-3000:]}\n{e[-3000:]}"
                          for r, (p, (o, e)) in enumerate(zip(procs, texts)))
        raise RuntimeError(f"launch_local: rank {failed} failed\n{tails}")
    return [o for o, _ in texts]
