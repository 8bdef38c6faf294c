"""The port's JPEG decoder (``rise_sdf_tpu_torch/utils/jpeg.py``) against
Pillow, the reader of the JAX package's COLMAP loader.

Bit-equal on every fixture of ``tests/data/jpeg`` (by the manifest's
SHA-256 of Pillow's decode, and against Pillow itself), on images
written here in grey and at 4:4:4, 4:2:2 and 4:2:0, with restart
intervals, optimised Huffman tables and qualities 50 to 100, at odd
sizes, and on ``chip_smoke.py``'s numpy JPEG writer's files.  Every
kind it does not read raises ``ValueError`` naming the file, and a
failed build raises with the compiler's output."""

import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from rise_sdf_tpu_torch.utils import jpeg

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jpeg")
with open(os.path.join(DATA, "manifest.json")) as _f:
    MANIFEST = json.load(_f)

SIZES = [(1, 1), (5, 7), (53, 37), (67, 129), (48, 64)]
MODES = ["L", "444", "422", "420"]
KINDS = [{"quality": 50}, {"quality": 90}, {"quality": 100},
         {"quality": 90, "optimize": True},
         {"quality": 85, "restart_marker_blocks": 2},
         {"quality": 85, "restart_marker_rows": 1}]


def _pixels(h, w, c, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([np.sin(x / (3.0 + k) + k) * 80
                     + np.cos(y / (5.0 - k) + 3 * k) * 40 + 128
                     for k in range(c)], -1)
    return np.clip(base + rng.randn(h, w, c) * 25, 0, 255).astype(np.uint8)


def _pil(buf):
    """What the JAX loader's PIL gives, with a channel axis."""
    img = np.asarray(Image.open(io.BytesIO(buf)))
    return img[..., None] if img.ndim == 2 else img


def _write(px, mode, **kw):
    img = Image.fromarray(px[..., 0] if mode == "L" else px,
                          "L" if mode == "L" else "RGB")
    if mode != "L":
        kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[mode]
    out = io.BytesIO()
    img.save(out, "JPEG", **kw)
    return out.getvalue()


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_is_bit_equal_to_pillow(name):
    path = os.path.join(DATA, name)
    got = jpeg.read_jpeg(path)
    want = MANIFEST["files"][name]
    assert list(got.shape) == want["shape"] and got.dtype == np.uint8
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    with open(path, "rb") as f:
        np.testing.assert_array_equal(got, _pil(f.read()))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_written_images_are_bit_equal_to_pillow(size, mode):
    h, w = size
    for seed, kw in enumerate(KINDS):
        px = _pixels(h, w, 1 if mode == "L" else 3, seed)
        buf = _write(px, mode, **kw)
        got = jpeg.decode_jpeg(buf)
        np.testing.assert_array_equal(got, _pil(buf), err_msg=str(kw))


@pytest.mark.parametrize("size", [(16, 16), (7, 5), (53, 37), (67, 130)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("quality", [50, 95])
def test_chip_smoke_encoder_decodes_alike(size, quality):
    h, w = size
    px = _pixels(h, w, 3, quality)
    buf = chip_smoke.encode_jpeg(px, quality=quality)
    assert b"\xff\xdd" in buf  # a restart interval
    got, want = jpeg.decode_jpeg(buf), _pil(buf)
    np.testing.assert_array_equal(got, want)
    # a sound encoding: the decode lies near the image
    mse = np.mean((got.astype(np.float64) - px) ** 2)
    assert 10 * np.log10(255 ** 2 / mse) > 20.0


def _segments(buf):
    """[(offset of the marker, marker byte, payload length)] up to SOS."""
    out, pos = [], 2
    while True:
        m = buf[pos + 1]
        n = struct.unpack(">H", buf[pos + 2:pos + 4])[0]
        out.append((pos, m, n))
        if m == 0xDA:
            return out
        pos += 2 + n


def _patched(buf, marker, offset, value):
    """``buf`` with byte ``offset`` of ``marker``'s payload set."""
    pos = next(p for p, m, _ in _segments(buf) if m == marker)
    b = bytearray(buf)
    b[pos + 4 + offset] = value
    return bytes(b)


def _unsupported():
    rgb = _pixels(24, 32, 3, 0)
    base = _write(rgb, "420", quality=90)
    grey = _write(rgb[..., :1], "L", quality=90)
    prog = io.BytesIO()
    Image.fromarray(rgb).save(prog, "JPEG", progressive=True)
    cmyk = io.BytesIO()
    Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1), "CMYK").save(
        cmyk, "JPEG")
    sof = next(p for p, m, _ in _segments(base) if m == 0xC0)

    def sof_marker(code):
        b = bytearray(base)
        b[sof + 1] = code
        return bytes(b)

    # a second scan: the grey file's SOS and data repeated before EOI
    sos = next(p for p, m, _ in _segments(grey) if m == 0xDA)
    two_scans = grey[:-2] + grey[sos:]
    return {
        "progressive": (prog.getvalue(), "progressive"),
        "cmyk": (cmyk.getvalue(), "four-component"),
        "lossless": (sof_marker(0xC3), "lossless"),
        "hierarchical": (sof_marker(0xC5), "hierarchical"),
        "arithmetic": (sof_marker(0xC9), "arithmetic"),
        "12-bit": (_patched(base, 0xC0, 0, 12), "12-bit"),
        "4:1:1": (_patched(base, 0xC0, 7, 0x41), "sampling"),
        "two-scans": (two_scans, "more than one scan"),
        "dnl-height": (_patched(_patched(base, 0xC0, 1, 0), 0xC0, 2, 0),
                       "DNL"),
        "truncated": (base[:len(base) // 2], "EOI|truncated|marker"),
        "not-jpeg": (b"\x89PNG\r\n\x1a\n" + bytes(16), "not a JPEG"),
    }


@pytest.mark.parametrize("kind", sorted(_unsupported()))
def test_unsupported_kinds_raise_naming_the_file(tmp_path, kind):
    buf, match = _unsupported()[kind]
    path = str(tmp_path / f"{kind}.jpg")
    with open(path, "wb") as f:
        f.write(buf)
    with pytest.raises(ValueError, match=rf"{kind}\.jpg: .*({match})"):
        jpeg.read_jpeg(path)


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "jpeg_decode.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(jpeg, "SOURCE", bad)
    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(jpeg, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)building jpeg_decode\.cpp "
                                           r"failed: .*error"):
        jpeg.load_library()
    assert not list((tmp_path / "_build").glob("*.so"))
