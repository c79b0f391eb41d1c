#!/usr/bin/env python
"""Export the inference graph, the model's forward and decode_detections,
as a torch.export program (counterpart of tools/export_model.py, which
writes StableHLO).

    python3 tools/export_model_torch.py CONFIG OUT.pt2 [--checkpoint FILE] \\
        [--batch 1] [--device cuda]

The input is a (batch, H, W, 3) float32 normalized canvas, H x W the
config's largest canvas bucket; the outputs are decode_detections' (dets
(batch, max_per_img, 27), labels, valid) with the config's test_cfg NMS
settings.  The model runs in the config's compute dtype with seeded random
weights, or those of --checkpoint (a checkpoint of tools/train_torch.py or
a state dict).  The four serving kernels are the custom ops orp::
min_area_rect, quad_over_mask, greedy_scan and deform_sample_pair, kept
whole in the graph: a process that loads the file with torch.export.load
imports orientedreppoints_tpu_torch.ops first, and then runs each op's CUDA
kernel on CUDA inputs (its plain version on CPU inputs).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import torch  # noqa: E402


def inference_module(model, test_cfg):
    """The model and decode_detections with test_cfg as one module:
    canvases (B, H, W, 3) -> (dets, labels, valid)."""
    from orientedreppoints_tpu_torch.apis import detect_core

    core = detect_core(test_cfg)

    class Inference(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, imgs):
            return core(self.model, imgs, 1.0)

    return Inference().eval()


def export(module, batch: int, canvas, device):
    """torch.export of module at (batch, *canvas, 3) float32 inputs."""
    x = torch.zeros((batch, *canvas, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        return torch.export.export(module, (x,))


def save(program, path: str) -> int:
    """torch.export.save without the example input (a zero canvas batch,
    86.7 MB at 4 x 1344^2), which the program does not need; returns the
    file's bytes."""
    program.example_inputs = None
    torch.export.save(program, path)
    return os.path.getsize(path)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("out", help="output .pt2 path")
    p.add_argument("--checkpoint",
                   help="a port checkpoint (file or directory) or a state "
                   "dict")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from orientedreppoints_tpu_torch.apis import init_detector
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.utils.checkpoint import load_weights

    cfg = load_config(args.config)
    tpu = cfg.get("tpu", {})
    model, _ = init_detector(cfg, device=args.device,
                             compute_dtype=tpu.get("compute_dtype",
                                                   "bfloat16"))
    if args.checkpoint:
        load_weights(model, args.checkpoint)
    canvas = tuple(tpu.get("canvas_buckets", [(1344, 1344)])[-1])
    t0 = time.perf_counter()
    program = export(inference_module(model, cfg["test_cfg"]), args.batch,
                     canvas, next(model.parameters()).device)
    size = save(program, args.out)
    print(f"exported {size / 1e6:.1f} MB torch.export program to {args.out} "
          f"({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
