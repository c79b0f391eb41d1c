"""HRSC2016 ship detection on the host (counterpart of devkit/hrsc.py):

  * _parse_hrsc_xml / generate_txt_labels (HRSC2DOTA.py:10-77): the XML
    annotations' rotated boxes (mbox cx, cy, w, h, ang) -> DOTA labelTxt
    lines "x1 y1 ... x4 y4 ship difficult", parsed with the stdlib;
  * prepare_hrsc2016 (prepare_hrsc2016.py): per split, the labelTxt, an
    `images` symlink to AllImages and the COCO-poly json of the .bmp
    images (sizes from their headers, data/image_io);
  * eval_hrsc2016 (hrsc2016_evaluation.py:87-269): the VOC AP of the one
    class "ship" over oriented polygons, VOC-07 11-point by default.
"""

from __future__ import annotations

import os
import os.path as osp
import xml.etree.ElementTree as ET

import numpy as np

from ..core.rbox import rbox2poly
from .dota2coco import dota2coco_train
from .evaluation import _imagenames, voc_eval_poly


def _parse_hrsc_xml(xml_file: str):
    """An HRSC XML -> [(cx, cy, w, h, ang, difficult)], one an
    HRSC_Object; a missing or empty field reads "0"."""
    root = ET.parse(xml_file).getroot()
    out = []
    for obj in root.iter("HRSC_Object"):
        def field(tag, default="0"):
            el = obj.find(tag)
            return el.text if el is not None and el.text else default

        out.append((float(field("mbox_cx")), float(field("mbox_cy")),
                    float(field("mbox_w")), float(field("mbox_h")),
                    float(field("mbox_ang")), field("difficult")))
    return out


def generate_txt_labels(root_path: str, img_dir: str = "AllImages",
                        ann_dir: str = "Annotations") -> str:
    """root_path/ann_dir/<name>.xml -> root_path/labelTxt/<name>.txt for
    each image in root_path/img_dir (an image without XML gets an empty
    file): each box as rbox2poly's corners, class ship, difficult 1 where
    the XML says "1", else 0.  Returns the labelTxt folder."""
    img_path = osp.join(root_path, img_dir)
    label_path = osp.join(root_path, ann_dir)
    out_path = osp.join(root_path, "labelTxt")
    os.makedirs(out_path, exist_ok=True)
    for img_name in sorted(os.listdir(img_path)):
        base = osp.splitext(img_name)[0]
        xml_file = osp.join(label_path, base + ".xml")
        lines = []
        if osp.exists(xml_file):
            for cx, cy, w, h, ang, difficult in _parse_hrsc_xml(xml_file):
                poly = rbox2poly(np.array([[cx, cy, w, h, ang]]))[0]
                coords = " ".join(str(v) for v in poly)
                flag = "1" if difficult == "1" else "0"
                lines.append(f"{coords} ship {flag}")
        with open(osp.join(out_path, base + ".txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    return out_path


def prepare_hrsc2016(root_path: str, ext: str = ".bmp"):
    """root_path/{Train,Test}/{AllImages,Annotations} -> each split's
    labelTxt, images -> AllImages symlink and hrsc_{train,test}.json."""
    for split in ("Train", "Test"):
        split_dir = osp.join(root_path, split)
        if not osp.isdir(split_dir):
            continue
        generate_txt_labels(split_dir)
        imgs = osp.join(split_dir, "images")
        if not osp.exists(imgs):
            os.symlink(osp.join(split_dir, "AllImages"), imgs,
                       target_is_directory=True)
        dota2coco_train(split_dir,
                        osp.join(split_dir, f"hrsc_{split.lower()}.json"),
                        cls_names=("ship",), ext=ext)


def eval_hrsc2016(detpath: str, annopath: str, imagesetfile_or_names,
                  ovthresh: float = 0.5, use_07_metric: bool = True):
    """HRSC VOC AP of the one class 'ship'."""
    names = _imagenames(imagesetfile_or_names)
    _, _, ap = voc_eval_poly(detpath, annopath, names, "ship", ovthresh,
                             use_07_metric)
    return ap
