"""Bilinear and trilinear ``grid_sample`` (align_corners, border
clamping) written as gathers and lerps (counterpart of
``rise_sdf_tpu/ops/grid_sample.py``).

The reference vendors CUDA kernels because torch's ``grid_sample`` has
no second derivative.  Here the taps are ``index_select`` gathers of
the flattened grid, whose backward is an ``index_add`` and is itself
differentiable, and the weights are plain arithmetic, so the result is
differentiable to any order in the grid's values and in the sample
positions.  Nothing in either package calls it yet.
"""

from __future__ import annotations

import torch

from .cubemap import _rows


def _axis(g, size):
    """Texel coordinate of ``g`` in [-1, 1] on an axis of ``size``:
    (lower index, upper index, weight of the upper [..., 1])."""
    f = (g * 0.5 + 0.5) * (size - 1)
    i0 = torch.clamp(torch.floor(f).long(), 0, size - 1)
    i1 = torch.clamp(i0 + 1, 0, size - 1)
    return i0, i1, torch.clamp(f - i0, 0.0, 1.0)[..., None]


def grid_sample_2d(image, grid):
    """image [H, W, C]; grid [..., 2] in [-1, 1] as (x, y) -> [..., C]."""
    h, w = image.shape[0], image.shape[1]
    x0, x1, wx = _axis(grid[..., 0], w)
    y0, y1, wy = _axis(grid[..., 1], h)
    flat = image.reshape(h * w, -1)

    def at(yi, xi):
        return _rows(flat, yi * w + xi)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def grid_sample_3d(volume, grid):
    """volume [D, H, W, C]; grid [..., 3] in [-1, 1] as (x, y, z), x
    along W (torch's convention) -> [..., C]."""
    d, h, w = volume.shape[0], volume.shape[1], volume.shape[2]
    x0, x1, wx = _axis(grid[..., 0], w)
    y0, y1, wy = _axis(grid[..., 1], h)
    z0, z1, wz = _axis(grid[..., 2], d)
    flat = volume.reshape(d * h * w, -1)

    def at(zi, yi, xi):
        return _rows(flat, (zi * h + yi) * w + xi)

    c00 = at(z0, y0, x0) * (1 - wx) + at(z0, y0, x1) * wx
    c01 = at(z0, y1, x0) * (1 - wx) + at(z0, y1, x1) * wx
    c10 = at(z1, y0, x0) * (1 - wx) + at(z1, y0, x1) * wx
    c11 = at(z1, y1, x0) * (1 - wx) + at(z1, y1, x1) * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz
