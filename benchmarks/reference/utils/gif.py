"""GIF89a in numpy: the port's writer for image sequences (the JAX
package writes them through imageio, which the port does not import).

``write_gif(path, frames, fps)`` writes 8-bit RGB frames, each
quantised to at most 256 colours with a palette of its own (a local
colour table; ``quantize``: the frame's own colours when it has at
most 256, else a median cut of its colours binned at 5 bits per
channel), LZW-coded with GIF's variable code width (9 to 12 bits, a
clear code when the table is full), a frame delay of ``round(100 /
fps)`` hundredths of a second and the NETSCAPE2.0 loop-forever block.
``read_gif(path)`` decodes such files (and any non-interlaced GIF) to
the frames as coded, each through its own colour table.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

_CLEAR, _EOI, _FIRST = 256, 257, 258
_MAX_CODE = 4095


def quantize(img: np.ndarray, colors: int = 256
             ) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 [H, W, 3] -> (indices uint8 [H, W], palette uint8 [n, 3]),
    ``n <= colors``.  ``palette[indices]`` is the frame a GIF shows.  A
    frame of at most ``colors`` colours keeps them exactly.  Otherwise
    its pixels are binned at 5 bits per channel and the occupied bins
    median-cut, count-weighted, along the widest channel of the box with
    the widest range, until there are ``colors`` boxes; a box's colour
    is the mean of its pixels."""
    h, w, _ = img.shape
    flat = img.reshape(-1, 3).astype(np.int64)
    key = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    present = np.flatnonzero(np.bincount(key, minlength=1 << 24))
    if len(present) <= colors:
        lut = np.zeros(1 << 24, np.uint8)
        lut[present] = np.arange(len(present))
        pal = np.stack([present >> 16, (present >> 8) & 255, present & 255],
                       -1)
        return lut[key].reshape(h, w), pal.astype(np.uint8)

    q = flat >> 3
    bin_key = (q[:, 0] << 10) | (q[:, 1] << 5) | q[:, 2]
    counts = np.bincount(bin_key, minlength=1 << 15)
    sums = np.stack([np.bincount(bin_key, flat[:, c], minlength=1 << 15)
                     for c in range(3)], -1)
    bins = np.flatnonzero(counts)
    counts, sums = counts[bins], sums[bins]
    cols = sums / counts[:, None]  # each bin's mean colour

    def score(box):
        """(widest channel's range, that channel) of a box of bins."""
        if len(box) < 2:
            return -1.0, 0
        span = cols[box].max(0) - cols[box].min(0)
        ch = int(span.argmax())
        return float(span[ch]), ch

    boxes = [np.arange(len(bins))]
    scores = [score(boxes[0])]
    while len(boxes) < colors:
        best = max(range(len(boxes)), key=lambda i: scores[i][0])
        if scores[best][0] <= 0:
            break
        box, ch = boxes[best], scores[best][1]
        box = box[np.argsort(cols[box, ch], kind="stable")]
        cum = np.cumsum(counts[box])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2) + 1, 1,
                          len(box) - 1))
        boxes[best], scores[best] = box[:cut], score(box[:cut])
        boxes.append(box[cut:])
        scores.append(score(box[cut:]))
    label = np.zeros(1 << 15, np.uint8)
    palette = np.empty((len(boxes), 3), np.uint8)
    for i, box in enumerate(boxes):
        label[bins[box]] = i
        palette[i] = np.rint(sums[box].sum(0) / counts[box].sum())
    return label[bin_key].reshape(h, w), palette


def _lzw_codes(data: bytes):
    """GIF LZW of 8-bit indices: (codes, widths), starting with a clear
    code and ending with end-of-information.  The width grows when the
    next free code no longer fits (checked after each code is written,
    as the decoder checks after each code is read); at code 4095 a clear
    code resets the table."""
    codes, widths = [_CLEAR], [9]
    put_code, put_width = codes.append, widths.append
    table = {}
    get = table.get
    nxt, width, limit = _FIRST, 9, 1 << 9
    prefix = data[0]
    for c in memoryview(data)[1:]:
        key = (prefix << 8) | c
        code = get(key)
        if code is not None:
            prefix = code
            continue
        put_code(prefix)
        put_width(width)
        if nxt >= limit and width < 12:
            width += 1
            limit <<= 1
        if nxt >= _MAX_CODE:
            put_code(_CLEAR)
            put_width(width)
            table.clear()
            nxt, width, limit = _FIRST, 9, 1 << 9
        else:
            table[key] = nxt
            nxt += 1
        prefix = c
    put_code(prefix)
    put_width(width)
    if nxt >= limit and width < 12:
        width += 1
    put_code(_EOI)
    put_width(width)
    return np.asarray(codes, np.int64), np.asarray(widths, np.int64)


def _pack_codes(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """Variable-width codes packed least significant bit first."""
    bit = np.arange(12)
    bits = ((codes[:, None] >> bit) & 1).astype(np.uint8)
    return np.packbits(bits[bit[None, :] < widths[:, None]],
                       bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for s in range(0, len(data), 255):
        part = data[s:s + 255]
        out += bytes([len(part)]) + part
    return bytes(out) + b"\x00"


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float = 30
              ) -> None:
    """Write uint8 [H, W, 3] frames as an animated GIF that loops."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    for f in frames:
        if f.ndim != 3 or f.shape[-1] != 3:
            raise ValueError(f"write_gif takes [H, W, 3] uint8 frames, not "
                             f"{f.shape}")
        if max(f.shape[:2]) > 65535:
            raise ValueError(f"a GIF frame is at most 65535 wide and high, "
                             f"not {f.shape[:2]}")
    if not frames:
        raise ValueError("write_gif takes at least one frame")
    sw = max(f.shape[1] for f in frames)
    sh = max(f.shape[0] for f in frames)
    delay = int(round(100.0 / fps))
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", sw, sh, 0, 0, 0))
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx, pal = quantize(f)
        table = np.zeros((256, 3), np.uint8)
        table[:len(pal)] = pal
        h, w = idx.shape
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87)
        out += table.tobytes() + b"\x08"
        out += _sub_blocks(_pack_codes(*_lzw_codes(idx.tobytes())))
    out += b"\x3b"
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def _read_sub_blocks(buf: bytes, off: int) -> Tuple[bytes, int]:
    parts = []
    while True:
        n = buf[off]
        off += 1
        if n == 0:
            return b"".join(parts), off
        parts.append(buf[off:off + n])
        off += n


def _lzw_decode(data: bytes, min_size: int, n_pixels: int) -> np.ndarray:
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    width = min_size + 1
    table: List[bytes] = [bytes([i]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    prev = None
    acc = n_bits = 0
    for byte in data:
        acc |= byte << n_bits
        n_bits += 8
        while n_bits >= width:
            code = acc & ((1 << width) - 1)
            acc >>= width
            n_bits -= width
            if code == clear:
                del table[clear + 2:]
                width, prev = min_size + 1, None
                continue
            if code == eoi:
                break
            if prev is None:
                entry = table[code]
            else:
                entry = table[code] if code < len(table) else \
                    prev + prev[:1]
                if len(table) < 4096:
                    table.append(prev + entry[:1])
                if len(table) == (1 << width) and width < 12:
                    width += 1
            out += entry
            prev = entry
        else:
            continue
        break
    if len(out) < n_pixels:
        raise ValueError(f"GIF image data ends after {len(out)} of "
                         f"{n_pixels} pixels")
    return np.frombuffer(bytes(out[:n_pixels]), np.uint8)


def read_gif(path: str) -> Tuple[List[np.ndarray], List[int]]:
    """(frames uint8 [h, w, 3] as coded, each through its colour table;
    their delays in hundredths of a second).  Interlaced frames raise
    ``ValueError``."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF")
    _, _, packed, _, _ = struct.unpack("<HHBBB", buf[6:13])
    off = 13
    global_table = None
    if packed & 0x80:
        n = 2 << (packed & 7)
        global_table = np.frombuffer(buf[off:off + 3 * n],
                                     np.uint8).reshape(n, 3)
        off += 3 * n
    frames, delays, delay = [], [], 0
    while off < len(buf):
        kind = buf[off]
        off += 1
        if kind == 0x3B:
            break
        if kind == 0x21:
            label = buf[off]
            off += 1
            body, off = _read_sub_blocks(buf, off)
            if label == 0xF9:
                delay = struct.unpack("<H", body[1:3])[0]
            continue
        if kind != 0x2C:
            raise ValueError(f"{path}: unknown block 0x{kind:02x}")
        _, _, w, h, packed = struct.unpack("<HHHHB", buf[off:off + 9])
        off += 9
        if packed & 0x40:
            raise ValueError(f"{path}: interlaced frames are not read")
        table = global_table
        if packed & 0x80:
            n = 2 << (packed & 7)
            table = np.frombuffer(buf[off:off + 3 * n],
                                  np.uint8).reshape(n, 3)
            off += 3 * n
        if table is None:
            raise ValueError(f"{path}: a frame without a colour table")
        min_size = buf[off]
        data, off = _read_sub_blocks(buf, off + 1)
        idx = _lzw_decode(data, min_size, w * h)
        frames.append(table[idx].reshape(h, w, 3))
        delays.append(delay)
    return frames, delays
