"""Training checkpoints in torch.save form (counterpart of
utils/checkpoint.py's save_checkpoint, load_checkpoint and
load_eval_variables).

A checkpoint is ckpt_dir/epoch_{N}.pt holding the model's state dict, the
SGD state with its momentum buffers, the LambdaLR state, the optimizer
step count and meta (the config text, the classes, the epoch N).  It is
written to a temporary file in ckpt_dir and renamed into place, so a
reader never sees half a file.  In data-parallel training rank 0 writes
it while the others wait at a barrier; every rank resumes from the same
file.  Loading is strict: a missing or extra
tensor, or an optimizer of other parameter groups, raises.  The JAX
package's orbax checkpoints reach the port as state dicts written by
tools/export_torch_state_dict.py, which runs where JAX is.

Also the pretrained-backbone converters: torchvision ResNet / ResNeXt
(counterpart of convert_torchvision_resnet and load_pretrained_backbone)
and official Swin (convert_swin_tiny and load_pretrained_swin), with the
bias-table resize through host.resize_cubic (cv2's bicubic in numpy).
"""

from __future__ import annotations

import os
import os.path as osp
import re

import numpy as np
import torch

from ..host import resize_cubic
from ..models.resnet import ARCH_SETTINGS
from ..parallel import dist

_NAME = re.compile(r"^epoch_(\d+)\.pt$")
KEYS = ("model", "optimizer", "scheduler", "step", "meta")


def save_checkpoint(ckpt_dir: str, epoch: int, model, optimizer, scheduler,
                    step: int, meta: dict | None = None, group=None) -> str:
    """Write ckpt_dir/epoch_{epoch}.pt atomically; returns its path.  With
    a data-parallel group rank 0 writes it (every replica holds the same
    state) and all ranks return after it is in place."""
    path = osp.join(ckpt_dir, f"epoch_{epoch}.pt")
    if dist.rank(group) == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        payload = dict(model=model.state_dict(),
                       optimizer=optimizer.state_dict(),
                       scheduler=scheduler.state_dict(), step=int(step),
                       meta=dict(meta or {}, epoch=int(epoch)))
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    dist.barrier(group)
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


def load_weights(model, path: str) -> None:
    """A checkpoint of tools/train_torch.py (a file, or a directory: its
    latest) or a bare state dict (tools/export_torch_state_dict.py) into
    model, strictly."""
    if not osp.isdir(path):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if set(payload) != set(KEYS):
            model.load_state_dict(payload, strict=True)
            return
    load_eval_variables(path, model)


# ---------------------------------------------------------------------------
# torchvision ResNet / ResNeXt weights (resnet18 .. resnet152,
# resnext50_32x4d, ...) -> the port's ResNet backbone
# ---------------------------------------------------------------------------

_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean",
       "running_var": "var"}


def convert_torchvision_resnet(state_dict: dict,
                               depth: int = 50) -> dict[str, torch.Tensor]:
    """A torchvision ResNet or ResNeXt state dict (numpy or tensor values)
    -> the detector's backbone tensors (`backbone.` names): conv1 / bn1 ->
    stem.conv / stem.bn, layer{s}.{b}.conv{i} / bn{i} -> layer{s}_{b}.
    conv{i}.conv / .bn, downsample.0 / .1 -> .downsample.conv / .bn; BN
    weight, bias, running_mean, running_var -> scale, bias, mean, var.
    Conv weights keep their OIHW layout (a ResNeXt's grouped conv2 too);
    fc and num_batches_tracked are dropped.  A tensor the depth needs and
    the dict lacks raises KeyError."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    out: dict[str, np.ndarray] = {}

    def conv_bn(dst, conv, bn):
        out[f"backbone.{dst}.conv.weight"] = sd[f"{conv}.weight"]
        for src, leaf in _BN.items():
            out[f"backbone.{dst}.bn.{leaf}"] = sd[f"{bn}.{src}"]

    conv_bn("stem", "conv1", "bn1")
    block_type, stage_blocks = ARCH_SETTINGS[depth]
    n_convs = 3 if block_type == "bottleneck" else 2
    for stage, blocks in enumerate(stage_blocks):
        for b in range(blocks):
            dst, src = f"layer{stage + 1}_{b}", f"layer{stage + 1}.{b}"
            for ci in range(1, n_convs + 1):
                conv_bn(f"{dst}.conv{ci}", f"{src}.conv{ci}", f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                conv_bn(f"{dst}.downsample", f"{src}.downsample.0",
                        f"{src}.downsample.1")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def load_pretrained_backbone(model, pth_path: str, depth: int = 50) -> None:
    """Overwrite the detector's ResNet / ResNeXt backbone from a
    torchvision .pth file (its `state_dict` wrapper unwrapped), strictly:
    every backbone tensor is replaced, and the neck and head keep their
    values.  Any other backbone raises ValueError."""
    if model.backbone_type != "resnet":
        raise ValueError(
            f"load_pretrained_backbone: torchvision ResNet / ResNeXt weights "
            f"do not fit a {model.backbone_type} backbone (Swin: "
            "load_pretrained_swin)")
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    prefix = "backbone."
    model.backbone.load_state_dict(
        {k[len(prefix):]: v
         for k, v in convert_torchvision_resnet(sd, depth).items()},
        strict=True)


# ---------------------------------------------------------------------------
# Official Swin weights (swin_tiny_patch4_window7_224 and its detection
# checkpoints) -> the port's Swin backbone
# ---------------------------------------------------------------------------


def interp_bias_table(table: np.ndarray, dst_len: int) -> np.ndarray:
    """A relative-position bias table (L1, nH) resized to (L2, nH) by a
    bicubic resize of its sqrt(L) x sqrt(L) grid, as the Swin-aware
    load_checkpoint does with cv2; unchanged when L1 == L2."""
    l1, nh = table.shape
    if l1 == dst_len:
        return table
    s1, s2 = int(np.sqrt(l1)), int(np.sqrt(dst_len))
    grid = table.reshape(s1, s1, nh).astype(np.float32)
    return resize_cubic(grid, (s2, s2)).reshape(s2 * s2, nh)


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
