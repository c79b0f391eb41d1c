"""The training driver: the step that apis.build_trainer returns, driven
back to back over pre-collated batches (data/loader.py's layout).

Set-up builds one trainer (model, optimizer, schedule, step) from the
seeded weights and drives it through check_steps steps on distinct
batches of the pool, through the window's own call and feed; those steps
warm up every shape.  The same trainer then runs the window: steps back
to back for --seconds, the losses read on the host every log_interval
steps and after the final synchronize.  Once the window has closed and
the program is dropped, the reference follows the first check_steps steps
from the same weights and batches in float32 and judges:

  loss_rel_gap     each step's total loss, |program - reference| /
                   |reference|, the worst step;
  loss_term_gap    each step's every loss term the same way, over the
                   larger of the term and a thousandth of the step's
                   total, the worst term of the worst step;
  grad_leaf_gap    the first step's gradient as the optimizer got it (from
                   its state after one step: SGD's momentum buffer less
                   the decay, AdamW's first moment over 1 - beta1), by
                   leaf: | ||program|| - ||reference|| | over the larger of
                   the reference leaf's norm and the median leaf's, the
                   worst leaf;
  change_leaf_gap  the parameters' change over the check steps, the same
                   way.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both leaf gaps (they move by round-off alone).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from port_bench.reference import detector, ops
from port_bench.reference import train as ref_train

from . import compare, measure, traffic, weights
from .main import Cell

SMALL_GRAD = 1e-3  # of the median leaf's reference gradient
SMALL_TERM = 1e-3  # of the step's reference total loss


def first_grads(optimizer, p0: dict, names: dict, cfg: dict) -> dict:
    """{leaf: norm of the first step's gradient} from the optimizer's
    state after one step."""
    opt = cfg["optimizer"]
    out = {}
    for p, name in names.items():
        st = optimizer.state.get(p, {})
        if opt["type"] == "SGD" and "momentum_buffer" in st:
            g = st["momentum_buffer"] - opt.get("weight_decay", 1e-4) * \
                p0[name]
        elif "exp_avg" in st:
            g = st["exp_avg"] / (1 - 0.9)
        else:  # no state: the optimizer did not take the step
            g = torch.zeros(())
        out[name] = float(g.norm())
    return out


def reference_steps(cell: Cell, batches: list, device, n: int,
                    precision: str | None = None) -> dict:
    """The reference's losses, first grads and change over n steps."""
    cfg = cell.cfg
    ops.f32_no_tf32()
    drawn = weights.draw(cfg, cell.traffic["weights"], cell.seed, device)
    params = {k: v.requires_grad_(detector.trainable(cfg, k))
              for k, v in drawn.items()}
    p0 = {k: v.detach().clone() for k, v in params.items() if v.requires_grad}
    tr = ref_train.Trainer(cfg, params, cell.seed,
                           chunk=cell.traffic["reference_chunk"])
    losses, grads = [], {}
    with ops.lower_precision(precision):
        for s in range(n):
            b = {k: torch.as_tensor(v, device=device)
                 for k, v in batches[s].items()}
            losses.append(tr.step(b))
            if s == 0:
                grads = {k: float(tr.p[k].grad.norm()) for k in tr.names}
    change = {k: float((tr.p[k].detach() - p0[k]).norm()) for k in p0}
    return {"losses": losses, "grads": grads, "change": change}


def term_gap(prog_losses: list, ref_losses: list) -> float:
    """The worst loss term of the worst step (a term the program does not
    report reads 1)."""
    worst = 0.0
    for a, b in zip(prog_losses, ref_losses):
        floor = SMALL_TERM * abs(b["loss_total"])
        for k, r in b.items():
            if k != "loss_total":
                worst = max(worst, abs(a.get(k, 0.0) - r) /
                            max(abs(r), floor, 1e-30))
    return worst


def numbers(prog: dict, ref: dict) -> dict:
    med = float(np.median(list(ref["grads"].values())))
    leaves = [k for k, v in ref["grads"].items() if v >= SMALL_GRAD * med]
    gap = max(abs(a["loss_total"] - b["loss_total"]) /
              max(abs(b["loss_total"]), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss_rel_gap": gap,
            "loss_term_gap": term_gap(prog["losses"], ref["losses"]),
            "grad_leaf_gap": compare.leaf_gap(prog["grads"], ref["grads"],
                                              leaves),
            "change_leaf_gap": compare.leaf_gap(prog["change"],
                                                ref["change"], leaves)}


def run(cell: Cell) -> dict:
    from orientedreppoints_tpu_torch.apis import build_trainer, init_detector

    mix, cfg, device = cell.traffic, cell.cfg, cell.device
    phases = measure.Phases(cell)
    measure.reset_peak(cell)
    sd = weights.draw(cfg, mix["weights"], cell.seed, device)
    phases.mark("weights")
    model, _ = init_detector(cfg, sd, cell.conf["compute_dtype"], device)
    del sd
    optimizer, _, step = build_trainer(model, cfg, seed=cell.seed)
    phases.mark("model")
    batches = traffic.train_batches(mix, cell.seed, cfg["tpu"]["max_gt"],
                                    device)
    phases.mark("inputs")
    names = {p: n for n, p in model.named_parameters() if p.requires_grad}
    p0 = {n: p.detach().clone() for p, n in names.items()}
    prog = {"losses": []}
    for s in range(mix["check_steps"]):
        out = step(batches[s])
        prog["losses"].append({k: float(v) for k, v in out.items()
                               if k.startswith("loss")})
        if s == 0:
            prog["grads"] = first_grads(optimizer, p0, names, cfg)
    prog["change"] = {n: float((p.detach() - p0[n]).norm())
                      for p, n in names.items()}
    del p0
    measure.sync(device)
    phases.mark("warm-up")
    setup_s = time.perf_counter() - cell.t_start
    nb, b = len(batches), mix["batch"]
    state = {"i": mix["check_steps"], "failed": 0}

    def one():
        out = step(batches[state["i"] % nb])
        state["i"] += 1
        return out

    def log(out):
        if not math.isfinite(float(out["loss_total"])):
            state["failed"] += 1

    metrics, extra, breakdown = {}, {}, None
    if cell.trace:
        last = {}

        def counted():
            last["out"] = one()
            return b
        rate = measure.rate(mix["rate_seconds"], counted, device)
        log(last["out"])

        def body():
            for _ in range(mix["trace_steps"]):
                out = one()
            log(out)
            return mix["trace_steps"] * b, mix["trace_steps"]
        metrics, extra, breakdown = measure.traced(cell, body, "train",
                                                   rate)
        attempted = (state["i"] - mix["check_steps"]) * b
    else:
        n, ends = 0, []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < cell.seconds:
            out = one()
            ends.append(time.perf_counter())
            n += 1
            if n % mix["log_interval"] == 0:
                log(out)
        log(out)
        measure.sync(device)
        window = time.perf_counter() - t0
        attempted = n * b
        gaps = 1e3 * np.diff([t0] + ends)
        measure.say(f"window {window:.3f} s, {n} steps, {attempted} images; "
                    "ms between the steps' returns on the host: "
                    f"median {np.median(gaps):.1f}, p90 "
                    f"{np.percentile(gaps, 90):.1f}, max {gaps.max():.1f}")
        values = {"train_images_per_s": attempted / window,
                  "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if k in units}
    peak = measure.memory_peak(cell)
    device_info = measure.device_info(cell, peak)
    device_info.update(extra)
    del model, optimizer, step, names
    measure.release()

    t = time.perf_counter()
    ref = reference_steps(cell, batches, device, mix["check_steps"])
    measure.say(f"reference {time.perf_counter() - t:.1f} s; losses "
                + "; ".join(f"program {a['loss_total']:.6g} reference "
                            f"{r['loss_total']:.6g}"
                            for a, r in zip(prog["losses"], ref["losses"])))
    checks = measure.judged(numbers(prog, ref), cell.limits)
    return measure.result(measure.all_within(checks)
                          and not state["failed"], attempted,
                          state["failed"], metrics, device_info, checks,
                          breakdown)
