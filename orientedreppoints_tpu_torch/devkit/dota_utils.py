"""DOTA labelTxt parsing and writing (counterpart of devkit/dota_utils.py,
itself after DOTA_devkit/dota_utils.py)."""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

DOTA10_CLASSES = (
    "plane", "baseball-diamond", "bridge", "ground-track-field",
    "small-vehicle", "large-vehicle", "ship", "tennis-court",
    "basketball-court", "storage-tank", "soccer-ball-field", "roundabout",
    "harbor", "swimming-pool", "helicopter",
)


def list_files(root: str, ext: str | None = None):
    """Every file under root ending in ext, sorted within each directory."""
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if ext is None or f.endswith(ext):
                out.append(osp.join(dirpath, f))
    return out


def basename_noext(path: str) -> str:
    return osp.splitext(osp.basename(path))[0]


def parse_dota_poly(label_file: str):
    """A labelTxt file -> [{'poly': (8,) float64, 'name', 'difficult'}].

    Skips the imagesource/gsd header lines; a missing difficult is '0'; a
    missing file gives no objects.
    """
    objects = []
    if not osp.exists(label_file):
        return objects
    with open(label_file, encoding="utf-8-sig") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 9:
                continue
            try:
                poly = np.array([float(v) for v in parts[:8]], np.float64)
            except ValueError:
                continue  # header line
            difficult = parts[9] if len(parts) > 9 else "0"
            objects.append(dict(poly=poly, name=parts[8],
                                difficult=str(difficult)))
    return objects


def poly_area(poly) -> float:
    """Shoelace area of one polygon, (2k,) or (k, 2)."""
    p = np.asarray(poly, np.float64).reshape(-1, 2)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)))


def write_dota_poly(label_file: str, objects):
    """Write objects as labelTxt lines 'x0 y0 ... x3 y3 name difficult'."""
    with open(label_file, "w") as f:
        for o in objects:
            coords = " ".join(str(v)
                              for v in np.asarray(o["poly"]).reshape(-1))
            f.write(f"{coords} {o['name']} {o['difficult']}\n")


def parse_tile_name(subname: str):
    """Invert the 'name__rate__left___up' tile naming -> (name, rate,
    left, up) (ResultMerge_multi_process.py:182-203)."""
    parts = subname.split("__")
    oriname = parts[0]
    rate = float(parts[1])
    # 'left___up' re-joins across the '__' split because '___' contains '__'
    left, up = "__".join(parts[2:]).split("___")
    return oriname, rate, int(left), int(up)
