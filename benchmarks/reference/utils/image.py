"""PIL's bicubic resize in numpy, and the loaders' image read (the port's
counterpart of ``np.asarray(Image.open(p).resize(wh, Image.BICUBIC))``
in the JAX package's TensoIR and Blender loaders).

``resize_like_pil`` follows Pillow's ``Image.resize`` step for step:
- at the native size it returns a copy;
- RGBA and LA images are resized premultiplied by alpha (PIL's ``RGBa``
  and ``La`` modes, in 8-bit fixed point) and divided by alpha after;
- each axis whose size changes is resampled on its own, columns first,
  with the cubic kernel of a = -0.5 whose support grows with the
  downscale factor; the weights are rounded to 22 fractional bits, each
  pass sums in integers and rounds and clips its result to 8 bits.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .png import read_png

PRECISION_BITS = 22  # Pillow's fixed-point weights (32 - 8 - 2)


def _cubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` (a = -0.5), in float64."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for
    the box [0, in_size): (first input index [out], int64 weights
    [out, taps], zero past each output's last input)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    first = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    count = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                       in_size) - first
    x = np.arange(taps)
    k = _cubic((x[None] + first[:, None] - center[:, None] + 0.5)
               / filterscale)
    k = np.where(x[None] < count[:, None], k, 0.0)
    total = np.zeros(out_size)
    for t in range(taps):  # the C loop's order of summation
        total = total + k[:, t]
    k = np.where(total[:, None] != 0.0, k / np.where(total == 0, 1, total)
                 [:, None], k)
    k = k * (1 << PRECISION_BITS)
    return first, np.trunc(np.where(k < 0, k - 0.5, k + 0.5)).astype(np.int64)


def _resample(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis`` of uint8
    [H, W, C]."""
    in_size = img.shape[axis]
    first, k = _coefficients(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    shape = (out_size,) + (1,) * (src.ndim - 1)
    for t in range(k.shape[1]):
        idx = np.minimum(first + t, in_size - 1)
        acc += src[idx] * k[:, t].reshape(shape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa (LA -> La): each colour times alpha / 255, rounded
    as Pillow's ``MULDIV255``."""
    alpha = img[..., -1:].astype(np.uint32)
    tmp = img[..., :-1].astype(np.uint32) * alpha + 128
    colour = ((tmp >> 8) + tmp) >> 8
    return np.concatenate([colour, alpha], -1).astype(np.uint8)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA (La -> LA): each colour times 255 / alpha, truncated
    and clipped, where alpha is neither 0 nor 255."""
    alpha = img[..., -1:].astype(np.uint32)
    colour = img[..., :-1].astype(np.uint32)
    div = np.minimum(colour * 255 // np.maximum(alpha, 1), 255)
    keep = (alpha == 0) | (alpha == 255)
    colour = np.where(keep, colour, div)
    return np.concatenate([colour, alpha], -1).astype(np.uint8)


def resize_like_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] (C = 1, 2, 3 or 4: L, LA, RGB, RGBA) resized to
    ``size`` = (w, h) as ``Image.resize(size, Image.BICUBIC)``."""
    w, h = int(size[0]), int(size[1])
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] not in (
            1, 2, 3, 4):
        raise ValueError(f"resize_like_pil takes uint8 [H, W, C<=4], not "
                         f"{img.dtype} {img.shape}")
    if (img.shape[1], img.shape[0]) == (w, h):
        return img.copy()
    alpha = img.shape[-1] in (2, 4)
    out = _premultiply(img) if alpha else img
    if out.shape[1] != w:
        out = _resample(out, w, 1)
    if out.shape[0] != h:
        out = _resample(out, h, 0)
    return _unpremultiply(out) if alpha else out


def read_image(path: str, size: Tuple[int, int]) -> np.ndarray:
    """The PNG at ``path`` resized to ``size`` = (w, h), as float32 in
    [0, 1]: [H, W] for grey images, else [H, W, C], as the JAX loaders'
    ``np.asarray(Image.open(path).resize(size, Image.BICUBIC),
    np.float32) / 255.0`` gives it."""
    img = resize_like_pil(read_png(path), size)
    if img.shape[-1] == 1:
        img = img[..., 0]
    return img.astype(np.float32) / 255.0
