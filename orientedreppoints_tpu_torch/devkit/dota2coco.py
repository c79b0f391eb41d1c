"""DOTA labelTxt -> COCO-poly json (counterpart of devkit/dota2coco.py's
dota2coco_train, after DOTA_devkit/DOTA2COCO_poly.py:16-123): bbox is the
8 polygon coordinates, categories in class order, difficult '2'
instances skipped.  Image sizes come from the .npy headers."""

from __future__ import annotations

import json
import os.path as osp

import numpy as np

from . import dota_utils as util


def dota2coco_train(srcpath: str, destfile: str,
                    cls_names=util.DOTA10_CLASSES,
                    skip_difficult: str = "2", ext: str = ".npy"):
    """srcpath/{images,labelTxt} -> destfile (returned)."""
    imagedir = osp.join(srcpath, "images")
    labeldir = osp.join(srcpath, "labelTxt")
    data = {
        "images": [],
        "categories": [
            {"id": i + 1, "name": n, "supercategory": n}
            for i, n in enumerate(cls_names)
        ],
        "annotations": [],
    }
    inst_id, image_id = 1, 1
    for label_file in util.list_files(labeldir, ".txt"):
        base = util.basename_noext(label_file)
        img_path = osp.join(imagedir, base + ext)
        if not osp.exists(img_path):
            continue
        h, w = np.load(img_path, mmap_mode="r").shape[:2]
        data["images"].append(
            {"file_name": base + ext, "id": image_id, "width": w, "height": h}
        )
        for obj in util.parse_dota_poly(label_file):
            if obj["difficult"] == skip_difficult:
                continue
            if obj["name"] not in cls_names:
                continue
            poly = [float(v) for v in np.asarray(obj["poly"]).reshape(-1)]
            data["annotations"].append({
                "id": inst_id,
                "image_id": image_id,
                "category_id": cls_names.index(obj["name"]) + 1,
                "bbox": poly,
                "segmentation": [poly],
                "iscrowd": 0,
                "area": util.poly_area(poly),
                # carried so that tile-level eval can apply VOC difficult
                # semantics
                "difficult": int(obj["difficult"]),
            })
            inst_id += 1
        image_id += 1
    with open(destfile, "w") as f:
        json.dump(data, f)
    return destfile
