#!/usr/bin/env python
"""Loss curves and epoch times from a training log (counterpart of
tools/analyze_logs.py): the lines 'epoch E iter I {json}' and
'epoch E done in Xs' that tools/train_torch.py and apis.train_epochs
write to train.log.

    python3 tools/analyze_logs_torch.py work_dir/train.log \\
        [--keys loss_total loss_cls] [--plot curves.png]

--plot needs matplotlib (imported only then).
"""

from __future__ import annotations

import argparse
import json
import re
import sys

LINE = re.compile(r"epoch (\d+) iter (\d+) (\{.*\})")
EPOCH = re.compile(r"epoch (\d+) done in ([0-9.]+)s")


def parse_log(path: str):
    """-> (iteration records with 'epoch' and 'iter' added, [(epoch,
    seconds)])."""
    iters, epochs = [], []
    with open(path) as f:
        for line in f:
            m = LINE.search(line)
            if m:
                rec = json.loads(m.group(3))
                rec["epoch"] = int(m.group(1))
                rec["iter"] = int(m.group(2))
                iters.append(rec)
            m = EPOCH.search(line)
            if m:
                epochs.append((int(m.group(1)), float(m.group(2))))
    return iters, epochs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log", help="train.log path")
    p.add_argument("--keys", nargs="+", default=["loss_total"])
    p.add_argument("--plot", help="optional output png")
    args = p.parse_args(argv)
    iters, epochs = parse_log(args.log)
    if not iters:
        print("no iteration records found")
        return 0
    for k in args.keys:
        vals = [r[k] for r in iters if k in r]
        if vals:
            print(f"{k}: first={vals[0]:.4f} last={vals[-1]:.4f} "
                  f"min={min(vals):.4f} mean={sum(vals)/len(vals):.4f}")
    if epochs:
        times = [t for _, t in epochs]
        print(f"epoch time: mean {sum(times)/len(times):.1f}s "
              f"min {min(times):.1f}s max {max(times):.1f}s over "
              f"{len(times)} epochs")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        for k in args.keys:
            ax.plot([r["iter"] for r in iters if k in r],
                    [r[k] for r in iters if k in r], label=k)
        ax.set_xlabel("iter")
        ax.legend()
        fig.savefig(args.plot, dpi=120)
        plt.close(fig)
        print("wrote", args.plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
