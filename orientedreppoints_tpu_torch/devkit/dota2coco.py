"""DOTA labelTxt -> COCO-poly json (counterpart of devkit/dota2coco.py's
dota2coco_train and dota2coco_test, after DOTA_devkit/DOTA2COCO_poly.py:
16-123): bbox is the 8 polygon coordinates, categories in class order,
difficult '2' instances skipped; the test json lists the images alone;
and generate_json_labels, DOTA2JSON's per-image list of xywh-angle boxes.
Image sizes come from the files' headers (data/image_io.image_size); an
image that is missing or whose header is not read is skipped, as the JAX
package skips what cv2.imread cannot read (a file damaged past its header
is kept here)."""

from __future__ import annotations

import json
import os.path as osp

import numpy as np

from ..core.rbox import poly2rbox
from ..data.image_io import ImageReadError, image_size
from . import dota_utils as util


def _size(path: str):
    """(h, w) of an image, or None where it is missing or unreadable."""
    try:
        return image_size(path)
    except (FileNotFoundError, ImageReadError):
        return None


def _categories(cls_names):
    return [{"id": i + 1, "name": n, "supercategory": n}
            for i, n in enumerate(cls_names)]


def dota2coco_train(srcpath: str, destfile: str,
                    cls_names=util.DOTA10_CLASSES,
                    skip_difficult: str = "2", ext: str = ".png"):
    """srcpath/{images,labelTxt} -> destfile (returned)."""
    imagedir = osp.join(srcpath, "images")
    labeldir = osp.join(srcpath, "labelTxt")
    data = {"images": [], "categories": _categories(cls_names),
            "annotations": []}
    inst_id, image_id = 1, 1
    for label_file in util.list_files(labeldir, ".txt"):
        base = util.basename_noext(label_file)
        size = _size(osp.join(imagedir, base + ext))
        if size is None:
            continue
        h, w = size
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


def dota2coco_test(srcpath: str, destfile: str,
                   cls_names=util.DOTA10_CLASSES, ext: str = ".png"):
    """srcpath/images -> an image-only json (the test split has no
    labelTxt), file names by basename; destfile is returned."""
    data = {"images": [], "categories": _categories(cls_names),
            "annotations": []}
    image_id = 1
    for img_path in util.list_files(osp.join(srcpath, "images"), ext):
        size = _size(img_path)
        if size is None:
            continue
        h, w = size
        data["images"].append({"file_name": osp.basename(img_path),
                               "id": image_id, "width": w, "height": h})
        image_id += 1
    with open(destfile, "w") as f:
        json.dump(data, f)
    return destfile


def generate_json_labels(srcpath: str, destfile: str, trainval: bool = True):
    """A list json of {filename, ann: {bboxes, labels, bboxes_ignore,
    labels_ignore}} per image, boxes as poly2rbox's (cx, cy, w, h, angle)
    and labels 1-based in DOTA-1.0 order, difficult '1' / '2' instances in
    the ignore lists (DOTA2JSON.py:55-92).  trainval: one record per
    srcpath/labelTxt file; else one per file in srcpath/images, without
    annotations.  destfile is returned."""
    labeldir = osp.join(srcpath, "labelTxt")
    if trainval:
        names = [util.basename_noext(p)
                 for p in util.list_files(labeldir, ".txt")]
    else:
        names = [util.basename_noext(p)
                 for p in util.list_files(osp.join(srcpath, "images"))]
    records = []
    for base in names:
        objs = (util.parse_dota_poly(osp.join(labeldir, base + ".txt"))
                if trainval else [])
        ann = {"bboxes": [], "labels": [], "bboxes_ignore": [],
               "labels_ignore": []}
        for o in objs:
            rb = poly2rbox(np.asarray(o["poly"])[None])[0].tolist()
            if o["name"] not in util.DOTA10_CLASSES:
                continue
            lab = util.DOTA10_CLASSES.index(o["name"]) + 1
            if o["difficult"] in ("1", "2"):
                ann["bboxes_ignore"].append(rb)
                ann["labels_ignore"].append(lab)
            else:
                ann["bboxes"].append(rb)
                ann["labels"].append(lab)
        records.append({"filename": base, "ann": ann})
    with open(destfile, "w") as f:
        json.dump(records, f)
    return destfile
