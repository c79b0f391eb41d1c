"""DOTA dataset over a COCO-poly json (counterpart of data/dota.py):
the 15 DOTA classes in the reference order (mmdet/datasets/dota.py:8-12)
(HrscDataset: the one class "ship"),
8-coordinate polygon annotations with 1-based labels and their difficult
flags, iscrowd skipped, images without annotations dropped outside
test_mode.  prepare(idx, rng) runs a train pipeline's random draws, and
a mosaic pipeline's extra samples, from the caller's RandomState."""

from __future__ import annotations

import json

import numpy as np

from ..devkit.dota_utils import DOTA10_CLASSES as DOTA_CLASSES
from .pipelines import MultiSamplePipeline

HRSC_CLASSES = ("ship",)


class DotaDataset:
    CLASSES = DOTA_CLASSES

    def __init__(self, ann_file: str, img_prefix: str = "", pipeline=None,
                 test_mode: bool = False):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        with open(ann_file) as f:
            coco = json.load(f)
        self.cat_id_to_label = {
            c["id"]: i + 1 for i, c in enumerate(coco["categories"])
        }
        anns_by_img = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.img_infos = []
        self.anns = []
        for img in coco["images"]:
            polys, labels, difficult = [], [], []
            for a in anns_by_img.get(img["id"], []):
                if a.get("iscrowd", 0):
                    continue
                bbox = np.asarray(a["bbox"], np.float32).reshape(-1)
                if bbox.size != 8:
                    continue
                polys.append(bbox)
                labels.append(self.cat_id_to_label[a["category_id"]])
                difficult.append(int(a.get("difficult", 0)))
            if not test_mode and len(polys) == 0:
                continue
            self.img_infos.append(img)
            self.anns.append(dict(
                bboxes=(np.stack(polys) if polys
                        else np.zeros((0, 8), np.float32)),
                labels=np.asarray(labels, np.int64),
                difficult=np.asarray(difficult, np.int64),
            ))
        # aspect-ratio group flag (w / h > 1 -> group 1)
        self.flag = np.array(
            [int(i["width"] / i["height"] > 1) for i in self.img_infos],
            dtype=np.uint8,
        )
        self.pipeline = pipeline

    def __len__(self):
        return len(self.img_infos)

    def get_raw(self, idx):
        return dict(img_info=self.img_infos[idx], ann_info=self.anns[idx],
                    img_prefix=self.img_prefix)

    def prepare(self, idx, rng: np.random.RandomState | None = None):
        """Item idx through the pipeline, its random draws from rng (the
        loader's); None when a step such as FilterEmpty drops it.  A
        MultiSamplePipeline (mosaic, mixup) also takes the raw items of
        rng.randint(len(self)), as the JAX dataset draws them from
        np.random."""
        results = self.get_raw(idx)
        if self.pipeline is None:
            return results
        if isinstance(self.pipeline, MultiSamplePipeline):
            if rng is None:
                raise ValueError("a MultiSamplePipeline draws at random: "
                                 "call prepare with an np.random."
                                 "RandomState")
            return self.pipeline(
                results, rng, lambda: self.get_raw(rng.randint(len(self))))
        return self.pipeline(results, rng)

    def __getitem__(self, idx):
        return self.prepare(idx)


class HrscDataset(DotaDataset):
    CLASSES = HRSC_CLASSES
