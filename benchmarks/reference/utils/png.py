"""PNG reader in numpy and ``zlib`` (the port's counterpart of PIL's
``Image.open`` in the JAX package's dataset loaders).

``read_png`` takes non-interlaced 8-bit images of colour type 0 (grey),
2 (RGB), 4 (grey + alpha) and 6 (RGBA), with any of the five row filters
on any row, and returns the bytes PIL gives (``np.asarray(Image.open(p))``,
but always with a channel axis).  Palette, 16-bit, sub-8-bit and
interlaced files raise ``ValueError``: PIL reads those too, but no scene
in the TensoIR or Blender layout uses them.

The filters Average and Paeth predict a byte from the decoded byte to
its left, so a row cannot be undone in one vector operation.  The
decoder sweeps the image's anti-diagonals instead: byte (r, x) depends
only on (r, x - 1), (r - 1, x) and (r - 1, x - 1), which lie on the two
diagonals before its own, so each of the H + W - 1 steps undoes one
whole diagonal of every row at once, whatever filter each row uses.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
from numpy.lib.stride_tricks import as_strided

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel
NONE, SUB, UP, AVERAGE, PAETH = range(5)


def _chunks(buf: bytes, path: str):
    """(kind, data) of every chunk up to IEND, each CRC checked."""
    off = len(_SIGNATURE)
    while True:
        if off + 12 > len(buf):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        n, kind = struct.unpack_from(">I4s", buf, off)
        data = buf[off + 8:off + 8 + n]
        (crc,) = struct.unpack_from(">I", buf, off + 8 + n) \
            if off + 12 + n <= len(buf) else (None,)
        if len(data) != n or crc != zlib.crc32(kind + data):
            raise ValueError(f"{path}: broken PNG chunk {kind!r} at byte "
                             f"{off}")
        yield kind, data
        if kind == b"IEND":
            return
        off += 12 + n


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG file as uint8 [H, W, C], C = 1, 2, 3 or 4."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = data
        elif kind == b"IDAT":
            idat.append(data)
    if header is None or len(header) != 13 or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", header)
    if colour == 3:
        raise ValueError(f"{path}: palette PNGs are not read")
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {colour}")
    if depth != 8:
        raise ValueError(f"{path}: only 8-bit PNGs are read, not {depth}-bit")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    c = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    stride = 1 + w * c
    if len(raw) < h * stride:
        raise ValueError(f"{path}: {len(raw)} bytes of image data where "
                         f"{h} rows take {h * stride}")
    rows = np.frombuffer(raw, np.uint8, count=h * stride).reshape(h, stride)
    filters = rows[:, 0]
    if filters.size and filters.max() > PAETH:
        raise ValueError(f"{path}: unknown PNG row filter "
                         f"{int(filters.max())}")
    return unfilter(filters, rows[:, 1:].reshape(h, w, c))


def _skew(img: np.ndarray, dtype) -> np.ndarray:
    """[H, W, C] -> [H + W - 1, H, C] with ``out[r + x, r] = img[r, x]``
    (zero where ``r + x`` names no pixel of row r)."""
    h, w, c = img.shape
    buf = np.zeros((h, h + w, c), dtype)
    es = buf.itemsize
    # row r of the view starts at buf[r, r]
    as_strided(buf, (h, w, c), ((h + w + 1) * c * es, c * es, es))[:] = img
    return np.ascontiguousarray(buf[:, :h + w - 1].transpose(1, 0, 2))


def _unskew(diag: np.ndarray, w: int) -> np.ndarray:
    """The inverse of ``_skew``: [H + W - 1, H, C] -> uint8 [H, W, C]."""
    d, h, c = diag.shape
    buf = np.zeros((h, h + w, c), np.uint8)
    buf[:, :d] = diag.transpose(1, 0, 2)
    es = buf.itemsize
    return as_strided(buf, (h, w, c),
                      ((h + w + 1) * c * es, c * es, es)).copy()


def unfilter(filters: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters: ``filters`` [H] (0-4), ``raw`` uint8
    [H, W, C] (the filtered bytes, one sample per channel) -> the image.
    The left neighbour of a byte is the same channel one pixel back."""
    h, w, c = raw.shape
    if h == 0 or w == 0:
        return raw.copy()
    n_diag = h + w - 1
    src = _skew(raw, np.int16)
    # out[d + 2, r + 1] holds diagonal d of row r; diagonals -2 and -1
    # and row -1 stay zero, the bytes PNG takes beyond the image's edge
    out = np.zeros((n_diag + 2, h + 1, c), np.int16)
    masks = {f: (filters == f).astype(np.int16)[:, None]
             for f in (SUB, UP, AVERAGE, PAETH) if (filters == f).any()}
    for d in range(n_diag):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        left = out[d + 1, lo + 1:hi + 1]
        up = out[d + 1, lo:hi]
        pred = np.zeros_like(left)
        for f, m in masks.items():
            m = m[lo:hi]
            if f == SUB:
                pred += m * left
            elif f == UP:
                pred += m * up
            elif f == AVERAGE:
                pred += m * ((left + up) >> 1)
            else:
                corner = out[d, lo:hi]
                pa = np.abs(up - corner)
                pb = np.abs(left - corner)
                pc = np.abs(left + up - 2 * corner)
                pred += m * np.where((pa <= pb) & (pa <= pc), left,
                                     np.where(pb <= pc, up, corner))
        out[d + 2, lo + 1:hi + 1] = (src[d, lo:hi] + pred) & 0xFF
    return _unskew(out[2:, 1:], w)
