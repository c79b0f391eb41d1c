"""Drawing of the visualisation tools (tools/browse_dataset_torch.py,
tools/show_points_and_boxes_torch.py; counterparts of the JAX tools'
cv2 calls) on BGR uint8 numpy images: polygons and filled circles as cv2
draws them, bit for bit (data/synth.py), numeric labels inside cv2's text
box in the port's own glyphs (data/text.py)."""

from __future__ import annotations

import numpy as np

from ..data import synth, text

# BGR, tools/show_points_and_boxes.py's palette
PALETTE = [
    (54, 67, 244), (99, 30, 233), (176, 39, 156), (183, 58, 103),
    (181, 81, 63), (243, 150, 33), (212, 188, 0), (136, 150, 0),
    (80, 175, 76), (74, 195, 139), (57, 220, 205), (59, 235, 255),
    (0, 152, 255), (34, 87, 255), (72, 85, 121),
]


def undo_normalize(img: np.ndarray, norm: dict) -> np.ndarray:
    """A Normalize'd float image back to BGR uint8, as the JAX tools undo
    it (a uint8 image is kept)."""
    if img.dtype == np.uint8:
        return np.ascontiguousarray(img)
    img = img * np.asarray(norm["std"], np.float32) + np.asarray(
        norm["mean"], np.float32)
    if norm.get("to_rgb", True):
        img = img[..., ::-1]
    return np.ascontiguousarray(np.clip(img, 0, 255).astype(np.uint8))


def draw_gts(img: np.ndarray, polys, labels) -> None:
    """browse_dataset: each gt polygon in green (thickness 2), its label in
    red (scale 0.5) at its first corner."""
    for poly, lab in zip(polys, labels):
        pts = np.round(np.asarray(poly).reshape(4, 2)).astype(np.int32)
        synth.polylines(img, pts, (0, 255, 0), 2)
        text.put_text(img, str(int(lab)), pts[0], 0.5, (0, 0, 255), 1)


def draw_dets(vis: np.ndarray, dets, labels, valid, score_thr: float) -> int:
    """show_points_and_boxes: one image's decoded rows [points(18),
    poly(8), score] scoring at least score_thr, each in its class's
    palette colour: the polygon (thickness 2), the 9 points as filled
    circles of radius 2, the score (scale 0.4) at the polygon's first
    corner.  Returns how many were drawn."""
    drawn = 0
    for d, lab, ok in zip(dets, labels, valid):
        if not ok or d[-1] < score_thr:
            continue
        color = PALETTE[int(lab) % len(PALETTE)]
        poly = np.round(d[18:26].reshape(4, 2)).astype(np.int32)
        synth.polylines(vis, poly, color, 2)
        for px, py in d[:18].reshape(9, 2):
            synth.fill_circle(vis, (int(px), int(py)), 2, color)
        text.put_text(vis, f"{d[-1]:.2f}", poly[0], 0.4, color, 1)
        drawn += 1
    return drawn
