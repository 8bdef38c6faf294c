"""Port parity: the port's image readers against the libraries the JAX
package reads through, on the CPU.

- ``utils/png.py:read_png`` against ``PIL.Image.open``, bit-equal, on
  files of colour types 0, 2, 4 and 6 written by PIL, by cv2 and by a
  small numpy encoder here that puts one chosen filter on every row
  (each of the five, and a mix), odd widths and 1-pixel images
  included; palette, 16-bit and interlaced files and a broken CRC
  raise.
- ``utils/hdr.py:read_hdr`` against ``cv2.imread(path,
  IMREAD_UNCHANGED)[..., ::-1]``, bit-equal, on run-length files that
  cv2 writes and flat files written here (``e == 0`` texels included),
  and against the JAX package's ``load_hdr_image`` on the same files.
- ``utils/image.py:resize_like_pil`` against PIL's BICUBIC resize on
  RGBA, LA, RGB and L images: a copy at the native size; at x1/2 and at
  non-integer factors within 1 code value, the contract.  Neither of the
  two steps that could part it from PIL (the premultiplied ``RGBa`` and
  ``La`` modes, the 8-bit fixed-point passes) does: both round as
  Pillow's C code does, and the result is bit-equal, which the test
  also holds.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from rise_sdf_tpu.models.light import load_hdr_image as jax_load_hdr
from rise_sdf_tpu_torch.models.light import load_hdr_image
from rise_sdf_tpu_torch.utils.hdr import read_hdr
from rise_sdf_tpu_torch.utils.image import read_image, resize_like_pil
from rise_sdf_tpu_torch.utils.png import read_png

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}
COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _image(h, w, c, seed=0):
    """A smooth image with noise, so that every filter has work to do;
    alpha, where there is one, takes 0 and 255 and values between."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([np.sin(xx / (3.0 + i) + i) * 70 + np.cos(yy / (4.0 + i))
                    * 50 + 128 + rng.integers(-25, 25, (h, w))
                    for i in range(c)], -1)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if c in (2, 4):
        img[: h // 3, ..., -1] = 0
        img[h // 3: h // 2, ..., -1] = 255
    return img


def _pil(img):
    c = img.shape[-1]
    return Image.fromarray(img[..., 0] if c == 1 else img, MODES[c])


def _pil_array(path):
    a = np.asarray(Image.open(path))
    return a[..., None] if a.ndim == 2 else a


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_png(path, img, filters, depth=8, interlace=0):
    """Write uint8 [H, W, C] with row filter ``filters[r % len]`` on row
    r (the filters computed from the image's bytes, as an encoder
    does)."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    left = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    up = np.pad(x, ((1, 0), (0, 0), (0, 0)))[:-1]
    corner = np.pad(x, ((1, 0), (1, 0), (0, 0)))[:-1, :-1]
    pred = [np.zeros_like(x), left, up, (left + up) >> 1,
            _paeth(left, up, corner)]
    rows = []
    for r in range(h):
        f = filters[r % len(filters)]
        rows.append(bytes([f]) + ((x[r] - pred[f][r]) & 255).astype(
            np.uint8).tobytes())
    header = struct.pack(">IIBBBBB", w, h, depth, COLOUR_TYPE[c], 0, 0,
                         interlace)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                 + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
                 + _chunk(b"IEND", b""))


SHAPES = [(1, 1), (1, 9), (7, 1), (13, 17), (32, 45)]


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_png_written_by_pil_reads_as_pil(tmp_path, c, shape):
    img = _image(*shape, c, seed=c)
    path = tmp_path / "a.png"
    _pil(img).save(path)
    got = read_png(path)
    np.testing.assert_array_equal(got, _pil_array(path))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_written_by_cv2_reads_as_pil(tmp_path, c):
    img = _image(31, 57, c, seed=5)
    path = str(tmp_path / "a.png")
    bgr = img[..., [2, 1, 0, 3][:c]] if c > 1 else img[..., 0]
    assert cv2.imwrite(path, bgr)
    np.testing.assert_array_equal(read_png(path), _pil_array(path))


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4], [4, 3, 1, 2, 0, 3]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "cycle", "mix"])
def test_every_png_filter_on_every_row(tmp_path, c, filters):
    for shape in ((1, 1), (9, 1), (1, 7), (23, 37)):
        img = _image(*shape, c, seed=len(filters) + c)
        path = tmp_path / f"{shape[0]}x{shape[1]}.png"
        _encode_png(path, img, filters)
        got = read_png(path)
        np.testing.assert_array_equal(got, _pil_array(path))
        np.testing.assert_array_equal(got, img)


def test_png_kinds_that_are_not_read_raise(tmp_path):
    img = _image(6, 5, 3)
    palette = tmp_path / "p.png"
    _pil(img).convert("P").save(palette)
    sixteen = tmp_path / "s.png"
    assert cv2.imwrite(str(sixteen), img.astype(np.uint16) * 257)
    interlaced = tmp_path / "i.png"
    _encode_png(interlaced, img, [0], interlace=1)
    for path, what in ((palette, "palette"), (sixteen, "16-bit"),
                       (interlaced, "interlaced")):
        with pytest.raises(ValueError, match=what) as err:
            read_png(path)
        assert str(path) in str(err.value)
    broken = tmp_path / "b.png"
    _encode_png(broken, img, [4])
    data = bytearray(broken.read_bytes())
    data[40] ^= 1  # inside the IDAT chunk
    broken.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="broken PNG chunk"):
        read_png(broken)


def _write_flat_hdr(path, rgbe):
    h, w, _ = rgbe.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode() + rgbe.tobytes())


def _cv2_rgb(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1]


def _assert_bits_equal(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(
        got.view(np.uint32), np.ascontiguousarray(want).view(np.uint32))


@pytest.mark.parametrize("shape", [(1, 8), (16, 32), (33, 71), (3, 5)])
def test_hdr_written_by_cv2_reads_as_cv2(tmp_path, shape):
    rng = np.random.default_rng(shape[1])
    img = (rng.random(shape + (3,)) ** 3 * 60).astype(np.float32)
    img[0, :2] = 0  # e == 0
    img[-1, -1] = [1e6, 2e-5, 0.5]
    img[..., 1][img[..., 0] > 30] = 7.0  # runs in one plane
    path = tmp_path / "env.hdr"
    assert cv2.imwrite(str(path), img[..., ::-1])  # cv2 takes BGR
    got = read_hdr(str(path))
    _assert_bits_equal(got, _cv2_rgb(path))
    _assert_bits_equal(load_hdr_image(str(path)), jax_load_hdr(str(path)))
    assert (got[0, :2] == 0).all()
    # cv2 writes by truncation: within the RGBE code's step of the max
    top = img.max(-1, keepdims=True)
    assert (np.abs(got - img) <= top * 2.0 ** -7).all()


@pytest.mark.parametrize("w", [5, 12])
def test_flat_hdr_reads_as_cv2(tmp_path, w):
    """Flat scanlines (width under 8 is always flat; at 12 the first
    scanline lacks the run-length marker), e == 0 texels with nonzero
    mantissas among them."""
    rng = np.random.default_rng(w)
    rgbe = rng.integers(0, 256, (4, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(100, 160, (4, w))
    rgbe[0, :3, 3] = 0
    rgbe[0, 0, :3] = [9, 200, 3]
    rgbe[0, 0, 0] = 1  # not the 2 2 marker
    path = tmp_path / "flat.hdr"
    _write_flat_hdr(path, rgbe)
    got = read_hdr(str(path))
    _assert_bits_equal(got, _cv2_rgb(path))
    _assert_bits_equal(load_hdr_image(str(path)), jax_load_hdr(str(path)))
    assert (got[0, :3] == 0).all()
    e = rgbe[1, 0, 3].astype(int)
    assert got[1, 0, 0] == rgbe[1, 0, 0] * 2.0 ** (e - 136)


def test_hdr_other_orientation_raises(tmp_path):
    path = tmp_path / "flip.hdr"
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 2 +X 2\n"
                + bytes(16))
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError, match="-Y H \\+X W"):
        read_hdr(str(path))


@pytest.mark.parametrize("c", [4, 2, 3, 1])
@pytest.mark.parametrize("size", [(64, 48), (32, 24), (27, 20), (64, 19),
                                  (40, 48), (101, 77), (1, 1)])
def test_resize_like_pil(c, size):
    img = _image(48, 64, c, seed=7)
    want = np.asarray(_pil(img).resize(size, Image.BICUBIC))
    want = want[..., None] if want.ndim == 2 else want
    got = resize_like_pil(img, size)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    np.testing.assert_array_equal(got, want)
    if size == (64, 48):
        np.testing.assert_array_equal(got, img)
        assert got is not img


@pytest.mark.parametrize("c", [1, 3, 4])
def test_read_image_is_the_loaders_pil_read(tmp_path, c):
    """``read_image`` is ``np.asarray(Image.open(p).resize(wh, BICUBIC),
    np.float32) / 255.0``, grey images without a channel axis."""
    img = _image(40, 30, c, seed=3)
    path = tmp_path / "a.png"
    _pil(img).save(path)
    for wh in ((30, 40), (15, 20), (11, 17)):
        want = np.asarray(Image.open(path).resize(wh, Image.BICUBIC),
                          np.float32) / 255.0
        got = read_image(path, wh)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
