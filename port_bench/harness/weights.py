"""Seeded weights, drawn on the card in a few large calls.

Each entry of the reference's parameter list (reference/detector.spec)
names its rule: normal(std), uniform(bound), trunc (a normal cut at two
sigma, scaled so its std is the given one, as flax draws it) or a
constant.  One normal draw and one uniform draw on a torch.Generator of
the card cover every entry; then the traffic's perturbation:

  * cls_out's bias from cls_bias, where the rules give it (from (-2, 1)
    every location scores above score_thr and the decode sees its full
    share of candidates; serve.draw_weights sets it from cls_share);
  * the point convs (pts_init_out, pts_refine_out) times points_scale (the
    nine points spread over about a stride, not on one spot);
  * cls_out's weight times cls_scale, where the rules give it (the class
    logits spread by far more than bfloat16's step at the score
    threshold);

and last the backbone's own rule, where its reference module has one
(perturb(params, gen): Swin's biases and norm affines).
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import detector

_TRUNC_UNIT_STD = 0.87962566103423978  # std of a unit normal cut at +-2


def draw(cfg: dict, rules: dict, seed: int, device) -> dict:
    """{state_dict name: float32 tensor on device}."""
    spec = detector.spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    unif = torch.rand(total, generator=gen, device=device)
    out, lo = {}, 0
    for (name, shape, (rule, v)), n in zip(spec, sizes):
        z, u = normal[lo:lo + n].view(shape), unif[lo:lo + n].view(shape)
        lo += n
        if rule == "normal":
            t = z * v
        elif rule == "trunc":
            t = z.clamp(-2.0, 2.0) * (v / _TRUNC_UNIT_STD)
        elif rule == "uniform":
            t = (u * 2.0 - 1.0) * v
        else:
            t = torch.full(shape, float(v), device=device)
        out[name] = t
    if "cls_bias" in rules:
        lo_b, hi_b = rules["cls_bias"]
        bias = out["bbox_head.cls_out.bias"]
        out["bbox_head.cls_out.bias"] = lo_b + (hi_b - lo_b) * torch.rand(
            bias.shape, generator=gen, device=device)
    for name in ("pts_init_out", "pts_refine_out"):
        out[f"bbox_head.{name}.weight"] = out[f"bbox_head.{name}.weight"] * \
            rules["points_scale"]
    if "cls_scale" in rules:
        out["bbox_head.cls_out.weight"] = out["bbox_head.cls_out.weight"] * \
            rules["cls_scale"]
    perturb = getattr(detector.backbone_module(cfg), "perturb", None)
    if perturb is not None:
        perturb(out, gen)
    return {k: v.contiguous() for k, v in out.items()}
