"""Training checkpoints in torch.save form (counterpart of
utils/checkpoint.py's save_checkpoint, load_checkpoint and
load_eval_variables).

A checkpoint is ckpt_dir/epoch_{N}.pt holding the model's state dict, the
SGD state with its momentum buffers, the LambdaLR state, the optimizer
step count and meta (the config text, the classes, the epoch N).  It is
written to a temporary file in ckpt_dir and renamed into place, so a
reader never sees half a file.  Loading is strict: a missing or extra
tensor, or an optimizer of other parameter groups, raises.  Reading the
JAX package's orbax checkpoints is not ported.

Also the official-Swin converter (counterpart of convert_swin_tiny and
load_pretrained_swin), with the bias-table resize's cv2 bicubic rebuilt
in numpy.
"""

from __future__ import annotations

import os
import os.path as osp
import re

import numpy as np
import torch

_NAME = re.compile(r"^epoch_(\d+)\.pt$")
KEYS = ("model", "optimizer", "scheduler", "step", "meta")


def save_checkpoint(ckpt_dir: str, epoch: int, model, optimizer, scheduler,
                    step: int, meta: dict | None = None) -> str:
    """Write ckpt_dir/epoch_{epoch}.pt atomically; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = osp.join(ckpt_dir, f"epoch_{epoch}.pt")
    payload = dict(model=model.state_dict(), optimizer=optimizer.state_dict(),
                   scheduler=scheduler.state_dict(), step=int(step),
                   meta=dict(meta or {}, epoch=int(epoch)))
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The path of the highest epoch in ckpt_dir, or None."""
    if not osp.isdir(ckpt_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir))
              if m]
    return osp.join(ckpt_dir, f"epoch_{max(epochs)}.pt") if epochs else None


def _read(path: str) -> dict:
    """A checkpoint file, or the latest one of a directory."""
    if osp.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no epoch_*.pt checkpoint in {path}")
        path = found
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or set(payload) != set(KEYS):
        raise ValueError(f"{path} is not a checkpoint of this package")
    return payload


def load_checkpoint(path: str, model, optimizer, scheduler):
    """Restore model, optimizer and scheduler in place from a checkpoint
    file or the latest of a directory; returns (step, meta)."""
    payload = _read(path)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    scheduler.load_state_dict(payload["scheduler"])
    return payload["step"], payload["meta"]


def load_eval_variables(path: str, model) -> dict:
    """Restore only the model's weights (strictly), for inference;
    returns the checkpoint's meta."""
    payload = _read(path)
    model.load_state_dict(payload["model"], strict=True)
    return payload["meta"]


# ---------------------------------------------------------------------------
# Official Swin weights (swin_tiny_patch4_window7_224 and its detection
# checkpoints) -> the port's Swin backbone
# ---------------------------------------------------------------------------


def _cubic_taps(src: int, dst: int):
    """cv2.resize INTER_CUBIC's taps along one axis, src -> dst samples:
    half-pixel source coordinates in float32, A = -0.75, the last weight
    as 1 minus the other three, and taps off the edge clamped to the
    border sample.  Returns (indices (dst, 4), weights (dst, 4) f32)."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = f - s.astype(np.float32)
    a = np.float32(-0.75)
    x1, y = x + np.float32(1), np.float32(1) - x
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * y - (a + 3)) * y * y + 1
    c3 = np.float32(1) - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, np.stack([c0, c1, c2, c3], -1).astype(np.float32)


def _resize_cubic(img: np.ndarray, out: int) -> np.ndarray:
    """cv2.resize(img, (out, out), interpolation=INTER_CUBIC) of a float32
    (S, S, C) grid, in OpenCV's own order of float32 operations: the
    horizontal pass sums the four taps in order; the vertical pass runs
    4-lane vectors over the first 4 * floor(out * C / 4) values of each
    row, summing the taps from the last to the first, and a scalar loop
    over the rest, summing them in order.  (cv2 hands 1-, 3- and
    4-channel float resizes to IPP where it has it, which rounds its
    weights otherwise: ~1e-6 of a value.)"""
    ix, wx = _cubic_taps(img.shape[1], out)
    iy, wy = _cubic_taps(img.shape[0], out)
    rows = img[:, ix[:, 0]] * wx[None, :, 0, None]
    for j in range(1, 4):
        rows = rows + img[:, ix[:, j]] * wx[None, :, j, None]
    taps = [rows[iy[:, j]] * wy[:, j, None, None] for j in range(4)]
    fwd = ((taps[0] + taps[1]) + taps[2]) + taps[3]
    rev = ((taps[3] + taps[2]) + taps[1]) + taps[0]
    flat = fwd.reshape(out, -1)
    n_vec = flat.shape[1] // 4 * 4
    flat[:, :n_vec] = rev.reshape(out, -1)[:, :n_vec]
    return flat.reshape(fwd.shape)


def interp_bias_table(table: np.ndarray, dst_len: int) -> np.ndarray:
    """A relative-position bias table (L1, nH) resized to (L2, nH) by a
    bicubic resize of its sqrt(L) x sqrt(L) grid, as the Swin-aware
    load_checkpoint does with cv2; unchanged when L1 == L2."""
    l1, nh = table.shape
    if l1 == dst_len:
        return table
    s1, s2 = int(np.sqrt(l1)), int(np.sqrt(dst_len))
    grid = table.reshape(s1, s1, nh).astype(np.float32)
    return _resize_cubic(grid, s2).reshape(s2 * s2, nh)


def convert_swin_tiny(state_dict: dict, window_size: int = 7,
                      depths=(2, 2, 6, 2)) -> dict[str, torch.Tensor]:
    """An official Swin state dict (numpy or tensor values, no `backbone.`
    prefix) -> the port's SwinTransformer state dict.

    patch_embed, each block's norms, qkv, proj, bias table (resized when
    the window differs) and MLP, the PatchMerging norms and reductions,
    and the out-norms: det checkpoints name them norm0..norm3, and a
    classification checkpoint's single final `norm` becomes the last
    stage's.  Dense and conv weights keep their torch layouts."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}
    out: dict[str, np.ndarray] = {}

    def copy(dst, src, leaves=("weight", "bias")):
        for leaf in leaves:
            if f"{src}.{leaf}" in sd:
                out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]

    copy("patch_embed", "patch_embed.proj")
    copy("patch_norm", "patch_embed.norm")
    tgt_len = (2 * window_size - 1) ** 2
    for st, depth in enumerate(depths):
        for b in range(depth):
            src, dst = f"layers.{st}.blocks.{b}", f"stage{st}_block{b}"
            for name in ("norm1", "norm2", "attn.qkv", "attn.proj"):
                copy(f"{dst}.{name}", f"{src}.{name}")
            copy(f"{dst}.mlp_fc1", f"{src}.mlp.fc1")
            copy(f"{dst}.mlp_fc2", f"{src}.mlp.fc2")
            out[f"{dst}.attn.relative_position_bias_table"] = \
                interp_bias_table(
                    sd[f"{src}.attn.relative_position_bias_table"], tgt_len)
        if f"layers.{st}.downsample.reduction.weight" in sd:
            copy(f"merge{st}.norm", f"layers.{st}.downsample.norm")
            copy(f"merge{st}.reduction", f"layers.{st}.downsample.reduction",
                 ("weight",))
    for st in range(len(depths)):
        if f"norm{st}.weight" in sd:
            copy(f"out_norm{st}", f"norm{st}")
        elif st == len(depths) - 1 and "norm.weight" in sd:
            copy(f"out_norm{st}", "norm")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def load_pretrained_swin(model, pth_path: str, window_size: int = 7,
                         depths=(2, 2, 6, 2)) -> list[str]:
    """Overwrite the detector's Swin backbone from an official .pth file
    (its `model` / `state_dict` wrapper unwrapped, `backbone.` prefixes
    stripped).  A tensor the file lacks (a classification checkpoint has
    only the last out-norm) keeps its value, as the JAX loader merges;
    a converted tensor the backbone lacks raises.  Returns the names of
    the backbone tensors that kept their values."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    for wrapper in ("model", "state_dict"):
        if wrapper in sd:
            sd = sd[wrapper]
    sd = {k.replace("backbone.", ""): v for k, v in sd.items()}
    missing, unexpected = model.backbone.load_state_dict(
        convert_swin_tiny(sd, window_size, depths), strict=False)
    if unexpected:
        raise ValueError(f"{pth_path}: tensors the backbone lacks: "
                         f"{unexpected}")
    return missing
