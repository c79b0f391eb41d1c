"""A JPEG round trip without a codec: the pixels that
cv2.imdecode(cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q])[1],
IMREAD_COLOR) gives for a uint8 BGR image, in numpy integer arithmetic
(the jpeg_compression corruption; cv2 is not a dependency of the port).

OpenCV 5.0 writes through libjpeg-turbo 3.1 a baseline (SOF0) file with
4:2:0 chroma (sampling (2, 2), (1, 1), (1, 1)), IJG's quality-scaled
tables and the islow DCT, and reads it back with the islow IDCT and fancy
upsampling.  Huffman coding is lossless, so the pixels depend only on the
quantised coefficients: round_trip runs the lossy stages and writes no
bitstream.  libjpeg-turbo's SIMD routines give the bits of its C code,
which is what is rebuilt here:

  * encode: jccolor's RGB -> YCbCr fixed-point tables (16 bits, Cb / Cr
    rounded by 0.5 - 2^-16); luma padded to whole blocks by repeating the
    last column and to a whole iMCU (16 rows) by repeating the last row;
    chroma from the image padded the same way to twice its block width
    and to even rows, h2v2 averaged with the alternating bias 1, 2, 1, ...,
    then padded to whole iMCUs by its last row; jfdctint's islow forward
    DCT of each 8 x 8 block (samples less 128; 13-bit constants, 2 pass
    bits); jcparam's quality scaling of the Annex K tables (q < 50:
    5000 / q, else 200 - 2 q; (t s + 50) / 100 clamped to 1..255) and
    jcdctmgr's quantiser, which multiplies by a 16-bit reciprocal of 8 t
    (compute_reciprocal: r = 16 + floor(log2 8 t), its rounding
    correction, (|x| + c) * recip >> r, the sign put back);
  * decode: coefficients times the table, jidctint's islow IDCT (the
    libjpeg 6b form) with its 10-bit range-limit table; h2v2 fancy
    upsampling of chroma (3/4, 1/4 triangle weights with the rows and
    columns beside it, edges repeated, biases 8 and 7), or plain
    replication when the chroma plane is 2 columns wide or less, as
    libjpeg-turbo's jdsample picks; jdcolor's YCbCr -> RGB tables,
    written as BGR.

The dummy blocks of a partial MCU (zero AC, the previous block's DC) lie
outside the image and change no pixel, so they are not formed.  Bit for
bit against cv2 5.0 (libjpeg-turbo 3.1.2) at qualities 1-100 on sizes
from 1 x 1 up, odd and not multiples of 8 or 16 included
(tests/test_torch_jpeg.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["round_trip", "quant_table"]

# IJG's Annex K tables, in natural (row-major) order
_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
_CHROMA = np.full((8, 8), 99, np.int64)
_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                   [47, 66, 99, 99]]

_SCALEBITS = 16  # colour tables


def _fix16(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_HALF16 = 1 << (_SCALEBITS - 1)
_CBCR_OFFSET = 128 << _SCALEBITS

_CONST_BITS = 13  # DCTs
_PASS1_BITS = 2


def _fix13(x: float) -> int:
    return int(x * (1 << _CONST_BITS) + 0.5)


(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (_fix13(v) for v in (
     0.298631336, 0.390180644, 0.541196100, 0.765366865, 0.899976223,
     1.175875602, 1.501321110, 1.847759065, 1.961570560, 2.053119869,
     2.562915447, 3.072711026))

# the IDCT's range limit: the descaled value masked to 10 bits -> sample
_RANGE = np.zeros(1024, np.int64)
_RANGE[:128] = np.arange(128, 256)
_RANGE[128:512] = 255
_RANGE[896:] = np.arange(128)


def quant_table(quality: int, chroma: bool = False) -> np.ndarray:
    """(8, 8) int64: jpeg_set_quality(quality, force_baseline=TRUE)'s
    luma or chroma table, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    base = _CHROMA if chroma else _LUMA
    return np.clip((base * scale + 50) // 100, 1, 255)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _butterfly_odd(t4, t5, t6, t7):
    """The odd part shared by both DCTs: (o7, o5, o3, o1) before descaling
    (forward), (t0, t1, t2, t3) (inverse)."""
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F1175
    t4, t5, t6, t7 = t4 * _F0298, t5 * _F2053, t6 * _F3072, t7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    return t4 + z1 + z3, t5 + z2 + z4, t6 + z2 + z3, t7 + z1 + z4


def _fdct_pass(d: np.ndarray, axis: int, last: bool) -> np.ndarray:
    """jfdctint's pass along axis of (..., 8, 8) int64 blocks: rows (the
    first, scaled up by 2^PASS1_BITS) or columns (the last)."""
    v = [np.take(d, i, axis=axis) for i in range(8)]
    t0, t7 = v[0] + v[7], v[0] - v[7]
    t1, t6 = v[1] + v[6], v[1] - v[6]
    t2, t5 = v[2] + v[5], v[2] - v[5]
    t3, t4 = v[3] + v[4], v[3] - v[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o = [None] * 8
    if last:
        o[0] = _descale(t10 + t11, _PASS1_BITS)
        o[4] = _descale(t10 - t11, _PASS1_BITS)
        sh = _CONST_BITS + _PASS1_BITS
    else:
        o[0] = (t10 + t11) << _PASS1_BITS
        o[4] = (t10 - t11) << _PASS1_BITS
        sh = _CONST_BITS - _PASS1_BITS
    z1 = (t12 + t13) * _F0541
    o[2] = _descale(z1 + t13 * _F0765, sh)
    o[6] = _descale(z1 - t12 * _F1847, sh)
    o7, o5, o3, o1 = _butterfly_odd(t4, t5, t6, t7)
    o[7], o[5], o[3], o[1] = (_descale(x, sh) for x in (o7, o5, o3, o1))
    return np.stack(o, axis=axis)


def _idct_pass(d: np.ndarray, axis: int, last: bool) -> np.ndarray:
    """jidctint's pass along axis: columns first, then rows (the last,
    descaled by 2^(PASS1_BITS + 3) more)."""
    v = [np.take(d, i, axis=axis) for i in range(8)]
    z1 = (v[2] + v[6]) * _F0541
    t2 = z1 - v[6] * _F1847
    t3 = z1 + v[2] * _F0765
    t0 = (v[0] + v[4]) << _CONST_BITS
    t1 = (v[0] - v[4]) << _CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    u0, u1, u2, u3 = _butterfly_odd(v[7], v[5], v[3], v[1])
    sh = (_CONST_BITS + _PASS1_BITS + 3 if last
          else _CONST_BITS - _PASS1_BITS)
    return np.stack([_descale(x, sh) for x in (
        t10 + u3, t11 + u2, t12 + u1, t13 + u0,
        t13 - u0, t12 - u1, t11 - u2, t10 - u3)], axis=axis)


def _reciprocal(divisor: int) -> tuple[int, int, int]:
    """libjpeg-turbo's compute_reciprocal for 16-bit DCT elements ->
    (reciprocal, correction, shift)."""
    r = 16 + divisor.bit_length() - 1
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:  # a power of two
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def _quantize(coef: np.ndarray, table: np.ndarray) -> np.ndarray:
    recip = np.array([_reciprocal(int(t) * 8) for t in table.reshape(-1)],
                     np.int64).T.reshape(3, 8, 8)
    q = ((np.abs(coef) + recip[1]) * recip[0]) >> recip[2]
    return np.where(coef < 0, -q, q)


def _code_plane(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """One padded (8 n, 8 m) component through DCT, quantiser and IDCT."""
    h, w = plane.shape
    blocks = (plane - 128).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    coef = _fdct_pass(_fdct_pass(blocks, -1, False), -2, True)
    deq = _quantize(coef, table) * table
    pix = _idct_pass(_idct_pass(deq, -2, False), -1, True)
    return _RANGE[pix & 1023].transpose(0, 2, 1, 3).reshape(h, w)


def _pad_edge(a: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])), mode="edge")


def _upsample_h2v2(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """jdsample's h2v2 fancy upsampling (plain replication at 2 columns
    or fewer) of a (ceil(h / 2), ceil(w / 2)) plane -> (h, w)."""
    if c.shape[1] <= 2:
        return np.repeat(np.repeat(c, 2, 0), 2, 1)[:h, :w]
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.int64)
    above = np.concatenate([c[:1], c[:-1]])
    below = np.concatenate([c[1:], c[-1:]])
    for v, near in ((0, above), (1, below)):
        s = 3 * c + near  # column sums
        left = np.concatenate([s[:, :1], s[:, :-1]], 1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        even = (3 * s + left + 8) >> 4
        odd = (3 * s + right + 7) >> 4
        even[:, 0] = (4 * s[:, 0] + 8) >> 4
        odd[:, -1] = (4 * s[:, -1] + 7) >> 4
        out[v::2, 0::2] = even
        out[v::2, 1::2] = odd
    return out[:h, :w]


def round_trip(img: np.ndarray, quality: int) -> np.ndarray:
    """The (h, w, 3) uint8 BGR image cv2.imdecode gives back for
    cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise TypeError(f"a (h, w, 3) uint8 image, not {img.dtype} "
                        f"{img.shape}")
    h, w = img.shape[:2]
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    y = (_fix16(0.299) * r + _fix16(0.587) * g + _fix16(0.114) * b
         + _HALF16) >> _SCALEBITS
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + _CBCR_OFFSET + _HALF16 - 1) >> _SCALEBITS
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + _CBCR_OFFSET + _HALF16 - 1) >> _SCALEBITS

    mcu_rows = -(-h // 16)
    luma = _code_plane(_pad_edge(y, 16 * mcu_rows, 8 * -(-w // 8)),
                       quant_table(quality))[:h, :w]
    ch, cw = -(-h // 2), -(-w // 2)
    cbw = 8 * -(-cw // 8)  # chroma width in whole blocks
    bias = np.tile([1, 2], cbw)[:cbw]
    chroma = []
    for plane in (cb, cr):
        full = _pad_edge(plane, 2 * ch, 2 * cbw).reshape(ch, 2, cbw, 2)
        small = (full.sum((1, 3)) + bias) >> 2
        coded = _code_plane(_pad_edge(small, 8 * mcu_rows, cbw),
                            quant_table(quality, chroma=True))
        chroma.append(_upsample_h2v2(coded[:ch, :cw], h, w))

    cb, cr = chroma[0] - 128, chroma[1] - 128
    red = luma + ((_fix16(1.402) * cr + _HALF16) >> _SCALEBITS)
    green = luma + ((-_fix16(0.34414) * cb + _HALF16
                     - _fix16(0.71414) * cr) >> _SCALEBITS)
    blue = luma + ((_fix16(1.772) * cb + _HALF16) >> _SCALEBITS)
    return np.clip(np.stack([blue, green, red], -1), 0, 255).astype(np.uint8)
