#!/usr/bin/env python
"""Export a JAX package checkpoint as a state dict of the PyTorch port.

    JAX_PLATFORMS=cpu python3 tools/export_torch_state_dict.py CONFIG \\
        CKPT_DIR OUT.pt [--step N]

Builds the config's JAX detector (utils/builder.build_detector), restores
its params and batch_stats from the orbax directory CKPT_DIR with
utils/checkpoint.load_eval_variables (a full TrainState checkpoint, as
tools/train.py and tools/synth_benchmark.py write, or a params-only one;
the latest step unless --step), converts them with the port's
utils/convert.flax_to_torch and writes torch.save(state_dict) to OUT.pt.
The file loads strictly into the port's detector of the same config:
apis.init_detector(CONFIG, state_dict=torch.load(OUT.pt)), or
tools/synth_benchmark_torch.py --state_dict OUT.pt.

Runs where JAX is, and imports both packages; the port imports neither
this tool nor JAX, so the machine that serves the weights needs only
torch.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("checkpoint", help="an orbax checkpoint directory")
    p.add_argument("out", help="the state dict file to write")
    p.add_argument("--step", type=int, help="default: the latest")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from orientedreppoints_tpu.utils import Config, builder
    from orientedreppoints_tpu.utils.checkpoint import load_eval_variables
    from orientedreppoints_tpu_torch.utils.convert import flax_to_torch

    cfg = Config.fromfile(args.config)
    model = builder.build_detector(cfg, "float32")
    # the template's shapes only: no compile, no init run
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    template = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                      dict(shapes))
    variables, step = load_eval_variables(args.checkpoint, template,
                                          args.step)
    sd = flax_to_torch(jax.tree_util.tree_map(np.array, variables))
    torch.save(sd, args.out)
    print(f"exported {len(sd)} tensors of step {step} to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
