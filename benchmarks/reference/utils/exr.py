"""Minimal OpenEXR 2.0 scanline reader and writer in numpy (counterpart
of ``rise_sdf_tpu/utils/exr.py``; the port keeps its own copy).

The reader takes float, half and uint scanline images stored with NONE,
ZIPS or ZIP compression (the zlib stream of a block holds the bytes
after OpenEXR's predictor and interleave, undone by
``_predictor_decode``), the variants Blender and TensoIR write.  The
writer emits uncompressed float32 scanlines, byte for byte as the JAX
package's does.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}  # UINT/HALF/FLOAT
_BYTES_PER_PX = {0: 4, 1: 2, 2: 4}
_LINES_PER_BLOCK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _read_cstring(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _predictor_decode(data: bytes) -> bytes:
    """Undo the zip blocks' post-processing: the delta predictor
    ``t[i] = t[i-1] + raw[i] - 128``, then the split of the bytes into
    two interleaved halves."""
    raw = np.frombuffer(bytes(data), np.uint8).astype(np.int64)
    out = np.empty_like(raw)
    out[0] = raw[0]
    np.cumsum(raw[1:] - 128, out=out[1:])
    out[1:] += out[0]
    out &= 0xFF
    n = len(out)
    half = (n + 1) // 2
    result = np.empty(n, np.uint8)
    result[0::2] = out[:half].astype(np.uint8)
    result[1::2] = out[half:].astype(np.uint8)
    return result.tobytes()


def _predictor_encode(data: bytes) -> bytes:
    """The inverse of ``_predictor_decode`` (interleave, then delta)."""
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    d = inter.astype(np.int64)
    out = np.empty_like(d)
    out[0] = d[0]
    out[1:] = d[1:] - d[:-1] + 128
    return (out & 0xFF).astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    """-> float32 [H, W, C]; channels ordered R, G, B, A when so named,
    the others after them."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise ValueError(f"tiled EXR is not supported: {path}")
    off = 8

    channels: List[Tuple[str, int]] = []
    compression, data_window, line_order = 0, None, 0
    while True:
        name, off = _read_cstring(buf, off)
        if name == "":
            break
        _type, off = _read_cstring(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        val = buf[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while val[coff] != 0:
                cname, coff = _read_cstring(val, coff)
                (ptype,) = struct.unpack_from("<i", val, coff)
                coff += 16  # pixel type, pLinear, reserved, sampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", val)
        elif name == "lineOrder":
            line_order = val[0]

    if data_window is None:
        raise ValueError(f"EXR without a dataWindow: {path}")
    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"unsupported EXR compression {compression}: "
                         f"{path}")
    xmin, ymin, xmax, ymax = data_window
    width, height = xmax - xmin + 1, ymax - ymin + 1
    per_block = _LINES_PER_BLOCK[compression]
    n_blocks = (height + per_block - 1) // per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, off)

    # each line holds the channels one after another, alphabetically
    out = {c: np.zeros((height, width), np.float32) for c, _ in channels}
    for boff in offsets:
        (y,) = struct.unpack_from("<i", buf, boff)
        (size,) = struct.unpack_from("<i", buf, boff + 4)
        data = buf[boff + 8: boff + 8 + size]
        y0 = y - ymin
        n_lines = min(per_block, height - y0)
        raw_size = sum(width * _BYTES_PER_PX[pt] for _, pt in channels) \
            * n_lines
        # a block that compression would not shrink is stored raw
        if compression in (2, 3) and size < raw_size:
            data = _predictor_decode(zlib.decompress(data))
        pos = 0
        for li in range(n_lines):
            for cname, ptype in channels:
                nb = width * _BYTES_PER_PX[ptype]
                line = np.frombuffer(data[pos:pos + nb], _PIXEL_DTYPES[ptype])
                out[cname][y0 + li] = line.astype(np.float32)
                pos += nb

    names = [c for c, _ in channels]
    order = [c for c in ["R", "G", "B", "A"] if c in names]
    order += [c for c in names if c not in order]
    img = np.stack([out[c] for c in order], axis=-1)
    if line_order == 1:  # DECREASING_Y
        img = img[::-1]
    return img


def write_exr(path: str, img: np.ndarray) -> None:
    """Write float32 [H, W] or [H, W, C] (R, G, B, A for C <= 4) as an
    uncompressed scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c] if c <= 4 else [f"C{i}" for i in range(c)]
    order = sorted(range(c), key=lambda i: names[i])

    def attr(name, typ, val):
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<i", len(val)) + val)

    chans = b""
    for i in order:
        chans += names[i].encode() + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    chans += b"\x00"
    header = attr("channels", "chlist", chans)
    header += attr("compression", "compression", b"\x00")
    header += attr("dataWindow", "box2i",
                   struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i",
                   struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_off = len(preamble) + 8 * h
    line_size = 8 + 4 * w * c
    offsets = struct.pack(f"<{h}Q",
                          *[table_off + i * line_size for i in range(h)])
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, 4 * w * c))
            for i in order:
                f.write(img[y, :, i].tobytes())
