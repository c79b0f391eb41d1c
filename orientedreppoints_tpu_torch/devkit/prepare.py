"""Dataset preparation entry points (counterpart of devkit/prepare.py):

  * prepare_dota1_train_val (prepare_dota1_train_val.py:17-70): the train
    and val scenes split at gap 200, subsize 1024 into trainval_split, the
    test scenes by SplitOnlyImage into test_split, then the COCO-poly
    jsons;
  * prepare_dota1_ms (prepare_dota1_ms.py:16-80): the same at gap 824 and
    rate 1.0, plus the other rates (0.5, 1.5) at gap 500, into
    trainval_split_ms and test_split_ms.

data_root holds {train,val,test}/images (PNG) and, for train and val,
labelTxt; a missing split is skipped.  Returns (trainval_out, test_out).
"""

from __future__ import annotations

import os
import os.path as osp

from .dota2coco import dota2coco_test, dota2coco_train
from .img_split import ImgSplit, SplitOnlyImage


def _jsons(trainval_out: str, test_out: str, has_test: bool):
    dota2coco_train(trainval_out, osp.join(trainval_out, "trainval_dota.json"))
    if has_test:
        dota2coco_test(test_out, osp.join(test_out, "test_dota.json"))


def prepare_dota1_train_val(data_root: str, out_root: str, gap: int = 200,
                            subsize: int = 1024, rates=(1.0,),
                            num_process: int = 8):
    """Single-scale DOTA-v1.0 preparation."""
    trainval_out = osp.join(out_root, "trainval_split")
    test_out = osp.join(out_root, "test_split")
    os.makedirs(trainval_out, exist_ok=True)
    os.makedirs(test_out, exist_ok=True)
    for split in ("train", "val"):
        src = osp.join(data_root, split)
        if not osp.isdir(src):
            continue
        s = ImgSplit(src, trainval_out, gap=gap, subsize=subsize,
                     num_process=num_process)
        for r in rates:
            s.splitdata(r)
    test_src = osp.join(data_root, "test")
    if osp.isdir(test_src):
        s = SplitOnlyImage(test_src, test_out, gap=gap, subsize=subsize,
                           num_process=num_process)
        for r in rates:
            s.splitdata(r)
    _jsons(trainval_out, test_out, osp.isdir(test_src))
    return trainval_out, test_out


def prepare_dota1_ms(data_root: str, out_root: str, gap_ss: int = 824,
                     gap_ms: int = 500, subsize: int = 1024,
                     ms_rates=(0.5, 1.0, 1.5), num_process: int = 8):
    """Multi-scale DOTA-v1.0 preparation: rate 1.0 at gap_ss, the other
    rates at gap_ms."""
    trainval_out = osp.join(out_root, "trainval_split_ms")
    test_out = osp.join(out_root, "test_split_ms")
    os.makedirs(trainval_out, exist_ok=True)
    os.makedirs(test_out, exist_ok=True)
    kw = dict(subsize=subsize, num_process=num_process)
    for split in ("train", "val"):
        src = osp.join(data_root, split)
        if not osp.isdir(src):
            continue
        ImgSplit(src, trainval_out, gap=gap_ss, **kw).splitdata(1.0)
        s = ImgSplit(src, trainval_out, gap=gap_ms, **kw)
        for r in ms_rates:
            if r != 1.0:
                s.splitdata(r)
    test_src = osp.join(data_root, "test")
    if osp.isdir(test_src):
        SplitOnlyImage(test_src, test_out, gap=gap_ss, **kw).splitdata(1.0)
        s = SplitOnlyImage(test_src, test_out, gap=gap_ms, **kw)
        for r in ms_rates:
            if r != 1.0:
                s.splitdata(r)
    _jsons(trainval_out, test_out, osp.isdir(test_src))
    return trainval_out, test_out
