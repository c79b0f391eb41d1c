#!/usr/bin/env python
"""Strip a training checkpoint to its model weights and name the file by
its content hash (counterpart of tools/publish_model.py).

    python3 tools/publish_model_torch.py CHECKPOINT OUT [--step N]

CHECKPOINT is a checkpoint of tools/train_torch.py (utils/checkpoint.py):
a file, or a directory, whose epoch_N.pt with --step N, else its latest.
Only the model's state dict is kept, written with torch.save to
OUT-<first 8 hex digits of its sha256>.pth; a file of that name already
there is left as it is.  The published file loads strictly as
apis.init_detector(config, state_dict=torch.load(file)).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", help="checkpoint file or directory")
    p.add_argument("out", help="output .pth prefix")
    p.add_argument("--step", type=int,
                   help="the epoch_N.pt of a checkpoint directory")
    args = p.parse_args(argv)

    import torch

    from orientedreppoints_tpu_torch.utils import checkpoint

    path = args.checkpoint
    if args.step is not None:
        path = osp.join(path, f"epoch_{args.step}.pt")
    payload = checkpoint._read(path)
    state = payload["model"]
    tmp = args.out + ".pth"
    torch.save(state, tmp)
    with open(tmp, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    final = f"{args.out}-{digest}.pth"
    if osp.exists(final):
        os.remove(tmp)
    else:
        os.replace(tmp, final)
    # JAX's line; its orbax step is the epoch, as here
    print("published", final,
          f"({len(state)} arrays, step {payload['meta']['epoch']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
