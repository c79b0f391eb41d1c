"""Run one benchmark cell once and print its result line.

    python port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration and its traffic are looked up by name in
BENCHMARK.json at the root of the checkout (see port_bench/README.md).
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel caches at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR",
                      str(ROOT / "build" / "port_bench" / "triton"))
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's own thread pools stay off the
# cores that launch the card's work
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")
sys.path.insert(0, str(ROOT))

from port_bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], ROOT, T_START))
