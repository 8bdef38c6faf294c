"""Radiance RGBE (``.hdr``) reader in numpy (the port's counterpart of
the ``cv2.imread`` in ``rise_sdf_tpu/models/light.py:load_hdr_image``).

The header runs from the ``#?`` magic line up to a blank line and must
name ``FORMAT=32-bit_rle_rgbe``; the next line gives the resolution,
which must be ``-Y H +X W`` (rows top to bottom, columns left to right),
the one orientation OpenCV reads.  Each scanline is stored in the new
run-length encoding (a ``2 2 hi lo`` marker, then the four component
planes, each as runs and literal spans) or flat, four bytes a pixel; as
in OpenCV, a scanline that does not start with the marker makes the
rest of the image flat, and widths outside [8, 32767] are always flat.

A texel (m_r, m_g, m_b, e) converts as OpenCV's ``rgbe2float`` does:
``m * 2^(e - 136)``, and 0 where ``e == 0`` (not Radiance's
``(m + 0.5) * 2^(e - 136)``), so the floats equal cv2's bit for bit.
"""

from __future__ import annotations

import re

import numpy as np

_RESOLUTION = re.compile(rb"([-+])([XY]) (\d+) ([-+])([XY]) (\d+)")


def _rle_scanline(buf: bytes, off: int, width: int, path: str):
    """One new-style run-length scanline at ``buf[off]`` (after its
    marker) -> (uint8 [4, width] planes, the offset after it)."""
    planes = np.empty((4, width), np.uint8)
    for p in range(4):
        x = 0
        while x < width:
            if off + 2 > len(buf):
                raise ValueError(f"{path}: truncated RGBE data")
            count = buf[off]
            if count > 128:  # a run of one value
                count -= 128
                if count > width - x:
                    raise ValueError(f"{path}: bad RGBE scanline data")
                planes[p, x:x + count] = buf[off + 1]
                off += 2
            else:  # a literal span
                if count == 0 or count > width - x \
                        or off + 1 + count > len(buf):
                    raise ValueError(f"{path}: bad RGBE scanline data")
                planes[p, x:x + count] = np.frombuffer(buf, np.uint8, count,
                                                       off + 1)
                off += 1 + count
            x += count
    return planes, off


def read_hdr(path: str) -> np.ndarray:
    """A Radiance RGBE file as float32 RGB [H, W, 3]."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file (no #? line)")
    end = buf.find(b"\n\n")
    if end < 0:
        raise ValueError(f"{path}: RGBE header without its blank line")
    if b"FORMAT=32-bit_rle_rgbe" not in buf[:end].split(b"\n"):
        raise ValueError(f"{path}: not FORMAT=32-bit_rle_rgbe")
    stop = buf.find(b"\n", end + 2)
    m = _RESOLUTION.fullmatch(buf[end + 2:stop]) if stop > 0 else None
    if m is None or m.group(1, 2, 4, 5) != (b"-", b"Y", b"+", b"X"):
        raise ValueError(f"{path}: resolution line "
                         f"{buf[end + 2:stop][:40]!r} is not '-Y H +X W'")
    h, w = int(m.group(3)), int(m.group(6))
    off = stop + 1
    rgbe = np.empty((h, w, 4), np.uint8)
    y = 0
    if 8 <= w <= 0x7FFF:
        while y < h:
            head = buf[off:off + 4]
            if len(head) < 4:
                raise ValueError(f"{path}: truncated RGBE data")
            if head[0] != 2 or head[1] != 2 or head[2] & 0x80:
                break  # not run-length encoded: the rest is flat
            if (head[2] << 8 | head[3]) != w:
                raise ValueError(f"{path}: wrong RGBE scanline width")
            planes, off = _rle_scanline(buf, off + 4, w, path)
            rgbe[y] = planes.T
            y += 1
    n = (h - y) * w * 4
    if len(buf) - off < n:
        raise ValueError(f"{path}: truncated RGBE data")
    rgbe[y:] = np.frombuffer(buf, np.uint8, n, off).reshape(h - y, w, 4)
    e = rgbe[..., 3:].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale
