"""Batch-inference serving (counterpart of serving.py), on one device or
sharded over every card of the host.

numpy BGR images in, per-class (k, 9) numpy arrays out:

    pred = Predictor("configs/dota/orientedreppoints_r50_demo.py",
                     state_dict=sd, device="cuda")
    dets = pred(images_bgr)

Each image is resized (keep ratio) and normalized on the device, pasted
onto a zero canvas of the config's last canvas bucket, and a batch of
canvases goes through the detector and decode_detections.  On a host with
two cards or more each batch is sharded over all of them
(parallel/infer.py, the JAX package's data_mesh) and its size rounded up
to a multiple of their count.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .apis import detect_core, infer_devices, init_detector, resolve_device
from .host import Normalize, imrescale, rbbox2result
from .parallel.infer import round_up_batch, shard_infer
from .utils.profiling import annotate


class Predictor:
    def __init__(self, config, state_dict: dict | None = None,
                 batch_size: int = 4, compute_dtype: str = "bfloat16",
                 test_cfg_overrides: dict | None = None, device="cuda",
                 devices="all"):
        """test_cfg_overrides: merged over the config's test_cfg (e.g.
        {'score_thr': 0.3, 'max_per_img': 100, 'pre_nms_cap': 1024}).
        devices: "all" shards every batch over the host's cards when
        `device` is a card and there are two or more; a list of devices
        over those (the model on `device`, a replica on each other); None
        on `device` alone."""
        self.device = resolve_device(device)
        self.model, self.cfg = init_detector(config, state_dict,
                                             compute_dtype, self.device)
        buckets = self.cfg.get("tpu", {}).get("canvas_buckets",
                                              [(1344, 1344)])
        self.canvas = tuple(buckets[-1])
        self.devices = infer_devices(devices, self.device)
        self.batch_size = round_up_batch(batch_size, self.devices)
        self.test_cfg = dict(self.cfg["test_cfg"])
        self.test_cfg.update(test_cfg_overrides or {})
        self._infer = shard_infer(detect_core(self.test_cfg), self.model,
                                  self.devices)
        norm = self.cfg["img_norm_cfg"]
        self._normalize = Normalize(norm["mean"], norm["std"],
                                    norm.get("to_rgb", True))
        self._scale = next(
            tuple(s["img_scale"]) for s in self.cfg["data"]["test"]["pipeline"]
            if s["type"] == "RotateResize")
        self.num_fg = self.cfg["model"]["bbox_head"]["num_classes"] - 1

    def _prep(self, img_bgr: np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img_bgr)).to(self.device)
        img, factor = imrescale(img, self._scale)
        img = self._normalize(img)
        canvas = torch.zeros(self.canvas + (3,), dtype=torch.float32,
                             device=self.device)
        canvas[:img.shape[0], :img.shape[1]] = img
        return canvas, float(factor)

    def prepare(self, images_bgr: Sequence[np.ndarray]):
        """At most batch_size images -> (canvases (batch_size, H, W, 3),
        scale factors (batch_size,)) on the device, zero-padded."""
        with annotate("orp.serve.prepare"):
            prepped = [self._prep(im) for im in images_bgr]
            pad = self.batch_size - len(prepped)
            imgs = torch.stack([p[0] for p in prepped]
                               + [torch.zeros_like(prepped[0][0])] * pad)
            sfs = torch.tensor([p[1] for p in prepped] + [1.0] * pad,
                               dtype=torch.float32, device=self.device)
            return imgs, sfs

    @torch.inference_mode()
    def infer(self, images_bgr: Sequence[np.ndarray]):
        """One batch -> device tensors (dets (batch_size, max_per_img, 27),
        labels, valid)."""
        imgs, sfs = self.prepare(images_bgr)
        return self._infer(imgs, sfs[:, None, None])

    def __call__(self, images_bgr: Sequence[np.ndarray]):
        out = []
        for lo in range(0, len(images_bgr), self.batch_size):
            chunk = images_bgr[lo:lo + self.batch_size]
            with annotate("orp.serve.call"):
                res = self.infer(chunk)
                with annotate("orp.serve.fetch"):
                    dets, labels, valid = (t.cpu().numpy() for t in res)
                with annotate("orp.serve.results"):
                    for bi in range(len(chunk)):
                        keep = valid[bi]
                        out.append(rbbox2result(dets[bi][keep][:, -9:],
                                                labels[bi][keep],
                                                self.num_fg + 1))
        return out
