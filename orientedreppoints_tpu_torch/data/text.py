"""Numeric labels drawn without cv2: a stroke face for 0-9 and '.', in
place of cv2.putText(..., FONT_HERSHEY_SIMPLEX, scale, colour, 1) of the
visualisation tools (tools/browse_dataset.py, show_points_and_boxes.py).

cv2 5.0 draws FONT_HERSHEY_SIMPLEX as an antialiased TrueType face, not as
Hershey strokes, so its glyphs are not rebuilt here; this face is the
port's own.  What is kept is cv2's box: the label's ink lies inside the
rectangle of cv2.getTextSize at org (x in [org.x, org.x + w], y in
[org.y - h, org.y + baseline]), and outside it the image is what cv2 would
leave.  TEXT_METRICS tabulates cv2 5.0's getTextSize at the tools' scales
and thickness 1: the height, each character's advance and descent; the
width of a string is its advances plus EXTRA, its baseline its largest
descent.  Each glyph is 7-segment strokes of data/synth.draw_line in its
advance, the baseline row the lowest.
"""

from __future__ import annotations

import numpy as np

from .synth import draw_line

# cv2 5.0 getTextSize(c, FONT_HERSHEY_SIMPLEX, scale, 1) at the tools'
# scales: scale -> (height, advance, descent); digits share an advance
_DIGITS = "0123456789"
_DESCENT = {c: int(c in "03568") for c in _DIGITS + "."}
TEXT_METRICS = {
    0.4: (11, {**dict.fromkeys(_DIGITS, 7), ".": 2}, _DESCENT),
    0.5: (14, {**dict.fromkeys(_DIGITS, 9), ".": 3}, _DESCENT),
}
EXTRA = 1  # the width beyond the advances' sum, at thickness 1

# strokes of each digit in a unit cell: x to the right, y up from the
# baseline; each a polyline
_T, _M, _B = 1.0, 0.5, 0.0
_GLYPHS = {
    "0": [[(0, _B), (1, _B), (1, _T), (0, _T), (0, _B)]],
    "1": [[(0.5, _B), (0.5, _T), (0.2, 0.8)]],
    "2": [[(0, _T), (1, _T), (1, _M), (0, _M), (0, _B), (1, _B)]],
    "3": [[(0, _T), (1, _T), (1, _B), (0, _B)], [(0, _M), (1, _M)]],
    "4": [[(0, _T), (0, _M), (1, _M)], [(1, _T), (1, _B)]],
    "5": [[(1, _T), (0, _T), (0, _M), (1, _M), (1, _B), (0, _B)]],
    "6": [[(1, _T), (0, _T), (0, _B), (1, _B), (1, _M), (0, _M)]],
    "7": [[(0, _T), (1, _T), (0.4, _B)]],
    "8": [[(0, _B), (1, _B), (1, _T), (0, _T), (0, _B)], [(0, _M), (1, _M)]],
    "9": [[(1, _M), (0, _M), (0, _T), (1, _T), (1, _B), (0, _B)]],
}


def _metrics(scale: float, thickness: int):
    if thickness != 1 or scale not in TEXT_METRICS:
        raise ValueError(f"labels are tabulated at scales "
                         f"{sorted(TEXT_METRICS)} and thickness 1, not "
                         f"({scale}, {thickness})")
    return TEXT_METRICS[scale]


def get_text_size(text: str, scale: float,
                  thickness: int = 1) -> tuple[tuple[int, int], int]:
    """cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, scale, thickness) of a
    string of digits and '.': ((width, height), baseline)."""
    height, advance, descent = _metrics(scale, thickness)
    width = sum(advance[c] for c in text) + EXTRA
    return (width, height), max(descent[c] for c in text)


def put_text(img: np.ndarray, text: str, org, scale: float, color,
             thickness: int = 1) -> None:
    """The label text with its baseline's left end at org (cv2.putText's
    org), its ink inside get_text_size's box there."""
    height, advance, _ = _metrics(scale, thickness)
    x0, y0 = int(org[0]), int(org[1])
    rows = height - 3  # the glyphs' height above the baseline row
    for c in text:
        a = advance[c]
        if c == ".":
            side = a - 2
            for dy in range(side + 1):
                draw_line(img, (x0, y0 - dy), (x0 + side, y0 - dy), color)
        else:
            cols = a - 2
            for stroke in _GLYPHS[c]:
                pts = [(x0 + int(round(u * cols)), y0 - int(round(v * rows)))
                       for u, v in stroke]
                for p, q in zip(pts, pts[1:]):
                    draw_line(img, p, q, color)
        x0 += a
