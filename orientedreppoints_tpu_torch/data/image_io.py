"""Image files without cv2: the counterpart of cv2.imread(path) (flag
IMREAD_COLOR) and cv2.imwrite(path, img) as the JAX package calls them,
in Python's zlib and struct and numpy.

  * imread -> BGR uint8 (H, W, 3), as cv2.IMREAD_COLOR gives it:
      - PNG, non-interlaced, bit depth 8 or 16, colour types 0 (grey),
        2 (RGB), 3 (palette), 4 (grey + alpha) and 6 (RGBA), every row
        filter (None, Sub, Up, Average, Paeth): grey replicated to three
        channels, alpha dropped, 16-bit samples cut to their high byte
        (libpng's png_set_strip_16);
      - BMP: uncompressed 24- and 32-bit (the fourth byte dropped; also
        BI_BITFIELDS with the standard masks) and 8-bit palette, bottom-up
        and top-down;
      - .npy: the array as saved (the port's own BGR arrays).
    Not read, and raising ImageReadError with the file's name: Adam7
    interlacing, bit depths under 8, a bad CRC or zlib stream, compressed
    BMPs, and every other extension (JPEG included).  cv2.imread returns
    None for an unreadable file; imread raises (FileNotFoundError for a
    missing one).
  * imwrite: a BGR uint8 image as PNG (every row Up filtered, zlib level
    1) or 24-bit BMP, or any array as .npy.  The bytes are not cv2's;
    cv2.imread gives back the array.
  * image_size -> (h, w) from the header alone (IHDR, BITMAPINFOHEADER,
    the .npy header).

PNG rows are unfiltered in numpy.  Sub, Average and Paeth take the
reconstructed left neighbour, so a file with Average or Paeth rows (which
libpng's adaptive encoder mixes in) is rebuilt as a wavefront: step t
rebuilds every pixel with x + y = t, whose left, upper and upper-left
neighbours lie on the two earlier diagonals; in the flat array padded by
one row and one column these are strided slices, one per step.
"""

from __future__ import annotations

import os.path as osp
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples
PNG_LEVEL = 1  # zlib level of imwrite's PNGs
BMP_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)  # R, G, B of BI_BITFIELDS
EXTENSIONS = (".png", ".bmp", ".npy")


class ImageReadError(ValueError):
    """A file that imread does not read: a format or feature outside its
    scope, or a damaged file."""


def _ext(path: str) -> str:
    ext = osp.splitext(path)[1].lower()
    if ext not in EXTENSIONS:
        raise ImageReadError(f"{path}: image_io reads and writes .png, "
                             f".bmp and .npy files, not {ext or 'no ext'}")
    return ext


def imread(path: str) -> np.ndarray:
    """path (.png / .bmp / .npy) -> BGR uint8 (H, W, 3), as
    cv2.imread(path) gives it; a .npy file is returned as saved."""
    ext = _ext(path)
    if ext == ".npy":
        return np.load(path)
    with open(path, "rb") as f:
        data = f.read()
    return _read_png(data, path) if ext == ".png" else _read_bmp(data, path)


def imwrite(path: str, img: np.ndarray) -> None:
    """Write img as the path's extension says: .png or .bmp (BGR uint8,
    (H, W, 3)) or .npy (the array as it is)."""
    ext = _ext(path)
    img = np.asarray(img)
    if ext == ".npy":
        np.save(path, img)
        return
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: PNG and BMP files are written from BGR "
                         f"uint8 (H, W, 3) images, not {img.dtype} "
                         f"{img.shape}")
    data = _encode_png(img) if ext == ".png" else _encode_bmp(img)
    with open(path, "wb") as f:
        f.write(data)


def image_size(path: str) -> tuple[int, int]:
    """(height, width) of an image file from its header alone."""
    ext = _ext(path)
    if ext == ".npy":
        return tuple(np.load(path, mmap_mode="r").shape[:2])
    with open(path, "rb") as f:
        head = f.read(26)
    if ext == ".png":
        if len(head) < 24 or head[:8] != PNG_SIGNATURE \
                or head[12:16] != b"IHDR":
            raise ImageReadError(f"{path}: not a PNG file")
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    if head[:2] != b"BM" or len(head) < 26:
        raise ImageReadError(f"{path}: not a BMP file")
    w, h = struct.unpack("<ii", head[18:26])
    return abs(h), w


# ------------------------------------------------------------------ PNG


def _png_chunks(data: bytes, path: str):
    """Yield (type, body) of each chunk after the signature, each CRC
    checked, up to IEND."""
    if data[:8] != PNG_SIGNATURE:
        raise ImageReadError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ImageReadError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ImageReadError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ImageReadError(f"{path}: PNG without IEND")


def _read_png(data: bytes, path: str) -> np.ndarray:
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ImageReadError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in PNG_CHANNELS or depth not in (8, 16):
        raise ImageReadError(f"{path}: PNG colour type {ctype} at bit depth "
                             f"{depth} is not read (8 and 16 bits only)")
    if ctype == 3 and (depth != 8 or palette is None):
        raise ImageReadError(f"{path}: palette PNG needs bit depth 8 and a "
                             "PLTE chunk")
    if interlace:
        raise ImageReadError(f"{path}: interlaced (Adam7) PNG is not read")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageReadError(f"{path}: bad zlib stream: {e}") from None
    bpp = PNG_CHANNELS[ctype] * depth // 8
    if len(raw) != h * (1 + w * bpp):
        raise ImageReadError(f"{path}: {len(raw)} bytes of image data, "
                             f"want {h * (1 + w * bpp)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp)
    if rows[:, 0].max(initial=0) > 4:
        raise ImageReadError(f"{path}: PNG row filter "
                             f"{rows[:, 0].max()} is not one of 0-4")
    px = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0])
    if depth == 16:
        px = px[..., 0::2]  # png_set_strip_16: the high byte
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        rgb = table[px[..., 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _unfilter(data: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """PNG's row filters undone: data (H, W, bpp) uint8 filtered bytes,
    filters (H,) the row filter types 0-4 -> the reconstructed bytes.  Rows
    of None, Sub and Up only are rebuilt row by row; any Average or Paeth
    row takes the wavefront over the anti-diagonals."""
    h, w, bpp = data.shape
    if filters.max(initial=0) <= 2:
        out = np.empty_like(data)
        prev = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            f = filters[y]
            if f == 0:
                out[y] = data[y]
            elif f == 1:
                np.cumsum(data[y], axis=0, dtype=np.uint8, out=out[y])
            else:
                np.add(data[y], prev, out=out[y])
            prev = out[y]
        return out
    # the wavefront: pixel (y, x) at (y + 1) (w + 1) + x + 1 of the padded
    # flat o, so x + y = t runs with stride w from y w + w + t + 2, and its
    # left, upper and upper-left neighbours sit 1, w + 1 and w + 2 before
    o = np.zeros(((h + 1) * (w + 1), bpp), np.int16)
    raw = data.reshape(h * w, bpp)
    f = filters.astype(np.int16)[:, None]
    zero = np.zeros((min(h, w), bpp), np.int16)
    rstep = max(w - 1, 1)
    for t in range(h + w - 1):
        y0, y1 = max(0, t - w + 1), min(h - 1, t)
        n = y1 - y0 + 1
        p0 = y0 * w + w + t + 2
        sl = slice(p0, p0 + (n - 1) * w + 1, w)
        a = o[p0 - 1:p0 + (n - 1) * w:w]
        b = o[p0 - w - 1:p0 + (n - 1) * w - w:w]
        c = o[p0 - w - 2:p0 + (n - 1) * w - w - 1:w]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(f[y0:y1 + 1], (zero[:n], a, b, (a + b) >> 1, paeth))
        r0 = y0 * (w - 1) + t
        o[sl] = (raw[r0:r0 + (n - 1) * rstep + 1:rstep] + pred) & 255
    return o.reshape(h + 1, w + 1, bpp)[1:, 1:].astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _encode_png(img: np.ndarray) -> bytes:
    h, w, _ = img.shape
    px = np.ascontiguousarray(img[..., ::-1]).reshape(h, w * 3)  # RGB
    up = px.copy()
    np.subtract(px[1:], px[:-1], out=up[1:])  # filter Up, wrapping
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), PNG_LEVEL))
            + _chunk(b"IEND", b""))


# ------------------------------------------------------------------ BMP


def _read_bmp(data: bytes, path: str) -> np.ndarray:
    if data[:2] != b"BM" or len(data) < 54:
        raise ImageReadError(f"{path}: not a BMP file")
    offset, dib = struct.unpack("<I I", data[10:18])
    if dib < 40:
        raise ImageReadError(f"{path}: BMP header of {dib} bytes is not "
                             "read (BITMAPINFOHEADER or later only)")
    w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
    colours = struct.unpack("<I", data[46:50])[0]
    if comp == 3 and bits == 32:
        masks = struct.unpack("<III", data[54:66])
        if masks != BMP_MASKS:
            raise ImageReadError(f"{path}: BMP bit fields {masks} are not "
                                 "read")
    elif comp != 0 or bits not in (8, 24, 32):
        raise ImageReadError(f"{path}: BMP of {bits} bits, compression "
                             f"{comp} is not read (8, 24, 32 bits "
                             "uncompressed only)")
    height = abs(h)
    stride = (w * bits + 31) // 32 * 4
    if len(data) < offset + stride * height:
        raise ImageReadError(f"{path}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, count=stride * height,
                         offset=offset).reshape(height, stride)
    rows = rows[:, :w * bits // 8]
    if h > 0:
        rows = rows[::-1]  # bottom-up
    if bits == 8:
        table = np.zeros((256, 3), np.uint8)
        n = min(colours or 256, 256)
        pal = np.frombuffer(data, np.uint8, count=4 * n, offset=14 + dib)
        table[:n] = pal.reshape(n, 4)[:, :3]
        return table[rows]
    return np.ascontiguousarray(rows.reshape(height, w, bits // 8)[..., :3])


def _encode_bmp(img: np.ndarray) -> bytes:
    """A bottom-up 24-bit BMP with a BITMAPINFOHEADER."""
    h, w, _ = img.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1].reshape(h, w * 3)
    return (b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size,
                          2835, 2835, 0, 0)
            + rows.tobytes())
