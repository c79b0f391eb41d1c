"""flax variables -> torch state_dict, without JAX.

Input: the JAX model's ``{"params": ..., "batch_stats": ...}`` tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, variables)``).
The torch modules use the flax tree's names, so a leaf path maps to a
state_dict key by joining with dots and renaming the leaf:

  conv kernel (HWIO)            -> weight (OIHW)
  Dense kernel (in, out)        -> weight (out, in)
  conv / Dense bias             -> bias
  GroupNorm scale / bias        -> weight / bias          (parent "gn")
  LayerNorm scale / bias        -> weight / bias          (parents norm1,
                                   norm2, norm, patch_norm, out_norm{s})
  Swin relative_position_bias_table -> same name, same layout
  FrozenBN scale, bias          -> scale, bias            (parent "bn")
  FrozenBN mean, var            -> mean, var              (batch_stats)
  SSD-VGG L2Norm weight (1-D)   -> weight
  DCN (K, Cin, Cout) weights    -> same name, same layout

Load the result with ``model.load_state_dict(sd, strict=True)``, which
fails on any flax leaf left unused or any torch tensor left unfilled.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# the parents of flax LayerNorm leaves in the Swin backbone
_LAYER_NORM = re.compile(r"^(norm[12]?|patch_norm|out_norm\d+)$")


def _flatten(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(path: tuple, value: np.ndarray):
    parent, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    if leaf == "kernel":
        if value.ndim == 2:  # Dense
            return "weight", value.T
        if value.ndim != 4:
            raise ValueError(f"{'/'.join(path)}: kernel must be a Dense "
                             "(in, out) or a conv HWIO")
        return "weight", value.transpose(3, 2, 0, 1)
    if (parent == "gn" or _LAYER_NORM.match(parent)) and leaf in ("scale",
                                                                   "bias"):
        return {"scale": "weight", "bias": "bias"}[leaf], value
    if leaf in ("bias", "scale", "mean", "var", "cls_dcn_weight",
                "refine_dcn_weight", "relative_position_bias_table") or (
            leaf == "weight" and value.ndim == 1):
        return leaf, value
    raise ValueError(f"{'/'.join(path)}: no torch counterpart")


def flax_to_torch(variables: dict) -> dict[str, torch.Tensor]:
    """Convert a flax variables tree (numpy leaves) to a torch state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name, arr = _leaf(path, np.asarray(value))
            key = ".".join(path[:-1] + (name,))
            if key in sd:
                raise ValueError(f"{key}: two flax leaves map to it")
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unconverted flax collections: {sorted(unknown)}")
    return sd
