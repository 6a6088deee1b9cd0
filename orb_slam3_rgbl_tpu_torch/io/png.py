"""PNG decoding and encoding with the standard library (``zlib`` + ``struct``)
and numpy.

The JAX package reads KITTI frames with ``cv2.imread``; the machine with the
card has no OpenCV, so the port decodes PNG itself. ``load_gray`` gives what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives, bit for bit: colour
becomes gray by libpng's fixed-point weights for 0.299 / 0.587 / 0.114,
``(9797·R + 19234·G + 3737·B) >> 15`` on 8-bit samples and, rounded, on
16-bit samples before their low byte is dropped; alpha is dropped; a 16-bit
gray sample keeps its high byte. ``read_png`` gives the samples as stored
(16-bit depth maps as uint16), as ``cv2.IMREAD_UNCHANGED`` does for gray.

Supported: non-interlaced 8- and 16-bit gray, gray-alpha, RGB and RGBA, all
five filter types. Interlaced, palette and sub-byte files raise a
``ValueError`` that names the file.

Unfiltering. Rows whose filters are None, Sub and Up are vectorized along
the row (Sub is a running sum mod 256). Average and Paeth make each byte
depend on the byte to its left, so a file that uses them is unfiltered by
anti-diagonals: every pixel of one diagonal depends only on the diagonal
before it, which takes H + W − 1 vectorized steps in place of H·W scalar
ones.

``write_png`` encodes the same kinds of image (8- and 16-bit gray,
gray-alpha, RGB, RGBA), each row under a chosen filter, so that the tools
can write depth maps and tests can write every filter the decoder reads.
``image_size`` reads only a file's header.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples a pixel (3, palette, is refused)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# libpng's RGB → gray weights (sum 32768 = 1.0 in 1.15 fixed point)
GRAY_WEIGHTS = (9797, 19234, 3737)


def _read_chunks(path: str):
    """(IHDR fields, concatenated IDAT bytes) of a PNG file; CRCs checked."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos: pos + 8])
        data = buf[pos + 8: pos + 8 + length]
        crc = struct.unpack(">I", buf[pos + 8 + length: pos + 12 + length])[0]
        if len(data) != length or zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    return header, b"".join(idat)


def _unfilter_rows(ftype: np.ndarray, f: np.ndarray, bpp: int) -> np.ndarray:
    """Rows filtered by None (0), Sub (1) and Up (2) only."""
    h, n = f.shape
    out = np.empty((h, n), np.uint8)
    prev = np.zeros(n, np.uint8)
    for r in range(h):
        t = ftype[r]
        if t == 0:
            row = f[r]
        elif t == 1:
            row = np.cumsum(f[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            row = f[r] + prev
        out[r] = row
        prev = out[r]
    return out


def _unfilter_diagonals(ftype: np.ndarray, f: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters, one anti-diagonal of pixels a step. A
    zero top row and left column stand for the bytes before the image."""
    h, n = f.shape
    w = n // bpp
    w1 = w + 1
    F = f.reshape(h * w, bpp).astype(np.int16)
    X = np.zeros(((h + 1) * w1, bpp), np.int16)        # padded, flat pixel rows
    onehot = (ftype[:, None] == np.arange(1, 5)[None, :])[:, :, None].astype(np.int16)
    rows = np.arange(h)
    for d in range(h + w - 1):
        r = rows[max(0, d - w + 1): min(h - 1, d) + 1]
        c = d - r
        i = (r + 1) * w1 + c + 1
        a, b, cc = X[i - 1], X[i - w1], X[i - w1 - 1]   # left, up, up-left
        # Paeth: |p − a|, |p − b|, |p − c| for p = a + b − c
        pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        m = onehot[r]                                     # Sub, Up, Average, Paeth
        pred = m[:, 0] * a + m[:, 1] * b + m[:, 2] * ((a + b) >> 1) + m[:, 3] * paeth
        X[i] = (F[r * w + c] + pred) & 255
    return X.reshape(h + 1, w1, bpp)[1:, 1:].astype(np.uint8).reshape(h, n)


def read_png(path: str) -> np.ndarray:
    """The samples of a PNG file as stored: (H, W) for gray, (H, W, C) for
    gray-alpha, RGB and RGBA (in that channel order); uint8 or uint16."""
    (w, h, depth, ctype, compression, filt, interlace), raw = _read_chunks(path)
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} (palette) is not supported")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} is not supported (8 or 16)")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if compression != 0 or filt != 0:
        raise ValueError(f"{path}: unknown compression or filter method")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    data = np.frombuffer(zlib.decompress(raw), np.uint8)
    if data.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {data.size} bytes of image data, expected {h * (1 + w * bpp)}")
    data = data.reshape(h, 1 + w * bpp)
    ftype, f = data[:, 0], data[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(ftype.max())}")
    if (ftype <= 2).all():
        px = _unfilter_rows(ftype, f, bpp)
    else:
        px = _unfilter_diagonals(ftype, f, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    shape = (h, w) if ch == 1 else (h, w, ch)
    return px.reshape(shape)


def to_gray(px: np.ndarray) -> np.ndarray:
    """``read_png`` samples → 8-bit gray, as ``cv2.IMREAD_GRAYSCALE``."""
    sixteen = px.dtype == np.uint16
    if px.ndim == 2 or px.shape[2] == 2:
        g = px if px.ndim == 2 else px[..., 0]
        return (g >> 8).astype(np.uint8) if sixteen else g.astype(np.uint8)
    r, g, b = (px[..., i].astype(np.int64) for i in range(3))
    wr, wg, wb = GRAY_WEIGHTS
    if sixteen:
        return (((wr * r + wg * g + wb * b + 16384) >> 15) >> 8).astype(np.uint8)
    return ((wr * r + wg * g + wb * b) >> 15).astype(np.uint8)


def load_gray(path: str) -> np.ndarray:
    """(H, W) uint8 gray image of a PNG file (``cv2.IMREAD_GRAYSCALE``)."""
    return to_gray(read_png(path))


def image_size(path: str) -> tuple:
    """(height, width) of a PNG file from its IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return int(h), int(w)


def write_png(path: str, arr: np.ndarray, filters=(1,)):
    """A non-interlaced PNG of ``arr`` — (H, W) gray, (H, W, 2) gray-alpha,
    (H, W, 3) RGB or (H, W, 4) RGBA; uint8 or uint16 — with the standard
    library: row r filtered by ``filters[r % len(filters)]`` (0 None, 1
    Sub, 2 Up, 3 Average, 4 Paeth), zlib-compressed."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16) or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] not in (2, 3, 4)):
        raise ValueError(f"{path}: cannot write a {arr.dtype} array of shape {arr.shape} as PNG")
    if any(f not in range(5) for f in filters):
        raise ValueError(f"{path}: row filters {tuple(filters)}; each must be 0..4")
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    depth = 16 if arr.dtype == np.uint16 else 8
    raw = (arr.astype(">u2") if depth == 16 else arr).tobytes()
    bpp = ch * depth // 8
    x = np.frombuffer(raw, np.uint8).reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    ft = np.array([filters[r % len(filters)] for r in range(h)], np.uint8)
    body = np.concatenate([ft[:, None], ((x - preds[ft, np.arange(h)]) & 255).astype(np.uint8)],
                          axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body, 6)) + chunk(b"IEND", b""))
