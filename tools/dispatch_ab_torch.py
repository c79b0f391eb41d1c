#!/usr/bin/env python
"""What the serving kernels' torch.library dispatch costs, on one NVIDIA GPU.

    python tools/dispatch_ab_torch.py [--root DIR] [--calls 200] \
        [--export_first]

Imports chip_smoke.py and the orientedreppoints_tpu_torch package from DIR
(default: this checkout), builds the kernels and runs the smoke's `slice`
phase (R-50 demo, bf16, batch 4, 8 images on the 1344^2 canvas) and its
`train` phase (R-50, 1344^2, bf16, batch 2, SGD) as chip_smoke.py's main
sets them up (the slice's model kept on the card meanwhile), printing
their lines (images/s, step ms).  Run it on two checkouts in one call,
A B B A, to compare them on one card.

Where DIR's entries are torch.library custom ops (orp::*), it then prints
(before the train phase with --export_first, as the smoke orders them)
  * one `[dispatch]` line: for each op, the microseconds of a call through
    the op and of a direct call of its CUDA kernel function on the same
    small inputs (each call ended by a synchronize; the smaller of two
    medians), so the difference is the dispatcher's host cost a call;
  * one `[export_profile]` line: the slice phase's model exported as
    tools/export_model_torch.py exports it, and for the eager module and
    ExportedProgram.module() over the slice's 8 images under no_grad, the
    wall ms a pass (median of 3), and under torch.profiler one pass's
    summed device time, its device events and its count of CPU ops.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import os.path as osp
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def per_call_us(fn, calls: int) -> float:
    """Median wall microseconds of fn() with a synchronize after each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def dispatch_costs(dev, calls: int) -> dict:
    """Each op through torch.ops against its *_kernel function, at small
    shapes where the kernel is short: {op: {op_us, kernel_us, extra_us}}."""
    from orientedreppoints_tpu_torch.ops import (deform_conv, minarearect,
                                                 nms, quad_iou)

    g = torch.Generator().manual_seed(0)
    pts = (torch.rand((256, 18), generator=g) * 64).to(dev)
    quads = (torch.rand((1, 256, 8), generator=g) * 64).to(dev)
    nv = torch.full((1,), 256, dtype=torch.int32, device=dev)
    mask = quad_iou.quad_over_mask_kernel(quads, 0.1, nv)
    valid = torch.ones((1, 256), dtype=torch.bool, device=dev)
    shapes = [(1, 8, 8)]
    table_a = torch.rand((64, 32), generator=g).to(dev, torch.bfloat16)
    table_b = torch.rand((64, 32), generator=g).to(dev, torch.bfloat16)
    offsets = torch.rand((64, 18), generator=g).to(dev, torch.bfloat16)
    pairs = {
        "min_area_rect": (lambda: minarearect.min_area_rect(pts),
                          lambda: minarearect.min_area_rect_kernel(pts)),
        "convex_hull": (lambda: minarearect.convex_hull_entry(pts),
                        lambda: minarearect.min_area_rect_kernel(pts)),
        "quad_over_mask": (
            lambda: quad_iou.quad_over_mask(quads, 0.1, nv),
            lambda: quad_iou.quad_over_mask_kernel(quads, 0.1, nv)),
        "greedy_scan": (lambda: nms.greedy_scan(mask, valid, nv),
                        lambda: nms.greedy_scan_kernel(mask, valid, nv)),
        "deform_sample_pair": (
            lambda: deform_conv.deform_sample_pair(table_a, table_b, offsets,
                                                   shapes),
            lambda: deform_conv.deform_sample_pair_kernel(
                table_a, table_b, offsets, shapes)),
    }
    out = {}
    for name, (op, kernel) in pairs.items():
        # alternate so that drift falls on both
        a, b = [], []
        for _ in range(2):
            a.append(per_call_us(op, calls))
            b.append(per_call_us(kernel, calls))
        out[name] = dict(op_us=min(a), kernel_us=min(b),
                         extra_us=min(a) - min(b))
    return out


def profiled_pass(fn) -> dict:
    """One synchronized call of fn under torch.profiler: the summed ms of
    its device events (kernels, copies, fills), their count and the count
    of CPU ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(
        device_ms=sum(e.device_time_total for e in device) / 1e3,
        device_events=len(device),
        cpu_ops=sum(1 for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU))


def export_profile(cs, pred, images, card) -> dict:
    """Eager module against its exported program on the slice's images."""
    tool = cs.load_tool("export_model_torch")
    module = tool.inference_module(pred.model, pred.test_cfg)
    canvas = tuple(pred.cfg["tpu"]["canvas_buckets"][-1])
    exported = tool.export(module, cs.EXPORT_BATCH, canvas,
                           pred.device).module()
    batches = [imgs for imgs, _ in cs.canvases(pred, images)]
    out = dict(images=len(images), card=card)
    with torch.no_grad():
        for name, fn in (("eager", module), ("exported", exported),
                         ("eager_again", module),
                         ("exported_again", exported)):
            def run():
                return [fn(x) for x in batches]
            run()  # warm-up
            torch.cuda.synchronize()
            out[name] = dict(wall_ms=statistics.median(
                cs.host_ms(run, cs.EXPORT_REPS)), **profiled_pass(run))
    return out


def report(cs, dev, pred, card, calls: int) -> None:
    print("[dispatch] " + json.dumps(dict(
        calls=calls, ops=dispatch_costs(dev, calls), card=card)))
    print("[export_profile] " + json.dumps(
        export_profile(cs, pred, pred.images, card)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose chip_smoke.py and package to run")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--export_first", action="store_true",
                    help="run the dispatch and export measurements before "
                    "the train phase, in chip_smoke.py's order")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dispatch_ab_torch: no CUDA device", file=sys.stderr)
        return 2
    root = osp.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    cs = importlib.import_module("chip_smoke")
    from orientedreppoints_tpu_torch import ops as ops_mod
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.ops import _ext, minarearect
    from orientedreppoints_tpu_torch.parallel.train import to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _ext.lib()
    custom = hasattr(minarearect.min_area_rect, "register_kernel")
    print(json.dumps(dict(root=root, custom_ops=custom, card=card)))
    torch.manual_seed(cs.SEED)
    ok_slice, _, pred, outs = cs.phase_slice(
        dev, np.random.default_rng(cs.SEED), ops_mod, card)
    del outs
    torch.cuda.empty_cache()
    # the train phase before the export and the profiler unless asked:
    # they may leave state in the process that the step then runs beside
    if custom and args.export_first:
        report(cs, dev, pred, card, args.calls)
    rng_train = np.random.default_rng(cs.SEED + 1)
    sd = cs.perturbed_weights(rng_train)
    max_gt = load_config(cs.CONFIG)["tpu"]["max_gt"]
    batch = to_device(cs.train_batch(rng_train, max_gt), dev)
    ok_train, _ = cs.phase_train(dev, ops_mod, card, sd, batch)
    del batch, sd
    torch.cuda.empty_cache()
    if custom and not args.export_first:
        report(cs, dev, pred, card, args.calls)
    return 0 if ok_slice and ok_train else 1


if __name__ == "__main__":
    sys.exit(main())
