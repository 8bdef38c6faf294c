"""Eval-time dense SDF bake (counterpart of ``rise_sdf_tpu/ops/sdf_bake.py``).

Once per checkpoint the full geometry SDF (hash encode + MLP) is
evaluated on the ``(cells+1)^3`` vertex lattice of the model AABB and
repacked so row ``(i*V + j)*V + k`` holds the 8 corner values of cell
``(i, j, k)``.  The visibility probe and the secondary occlusion march
then read one 32-byte row per sample (kernel G1, ``ops/gather.py``, with
8-wide rows on the card) instead of 8 corners x L hash levels and the
SDF MLP.

* ``bake_sdf_vertices``  -- lattice evaluation in chunks
* ``pack_corners``       -- ``[V, V, V] -> [V^3, 8]`` corner-packed table
* ``bake_packed`` / ``bake_for_model`` -- both steps in one call
* ``sample_packed``      -- trilinear SDF
* ``sample_packed_grad`` -- trilinear SDF and its analytic cell gradient
"""

from __future__ import annotations

import torch

from .gather import gather_rows

# corner order: bit 2 = dx, bit 1 = dy, bit 0 = dz  (c = 4*dx + 2*dy + dz)
_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


@torch.no_grad()
def bake_sdf_vertices(sdf_fn, aabb_min, aabb_max, cells: int,
                      chunk: int = 1 << 18):
    """``sdf_fn`` ([N, 3] world positions -> [N]) on the ``(cells+1)^3``
    vertex lattice, ``chunk`` points at a time -> ``[V, V, V]``."""
    v = cells + 1
    dev = aabb_min.device
    aabb_min = aabb_min.float()
    aabb_max = aabb_max.float()
    lin = torch.arange(v, dtype=torch.float32, device=dev) / cells
    idx = torch.arange(v * v * v, device=dev)
    u = torch.stack([lin[idx // (v * v)], lin[(idx // v) % v], lin[idx % v]],
                    -1)
    pts = aabb_min + u * (aabb_max - aabb_min)
    vals = [sdf_fn(pts[s:s + chunk]) for s in range(0, pts.shape[0], chunk)]
    return torch.cat(vals).reshape(v, v, v)


def pack_corners(vertices):
    """``[V, V, V]`` vertex SDF -> ``[V^3, 8]`` corner-packed cell table.
    Rows at the high boundary repeat the clamped edge (never sampled:
    cell indices are clamped to ``V-2``)."""
    v = vertices.shape[0]
    i = torch.arange(v, device=vertices.device)
    nxt = torch.clamp(i + 1, max=v - 1)
    packed = []
    for dx, dy, dz in _CORNERS:
        ix, iy, iz = (nxt if dx else i), (nxt if dy else i), (nxt if dz else i)
        packed.append(vertices[ix][:, iy][:, :, iz].reshape(-1))
    return torch.stack(packed, -1).contiguous()


def bake_packed(sdf_fn, aabb_min, aabb_max, cells: int,
                chunk: int = 1 << 18):
    """Vertex lattice -> ``{"packed": [V^3, 8] float32, "cells": int}``."""
    verts = bake_sdf_vertices(sdf_fn, aabb_min, aabb_max, cells, chunk)
    return {"packed": pack_corners(verts), "cells": int(cells)}


def bake_for_model(model, step):
    """The model's full geometry SDF baked at ``eval_sdf_bake_cells``, or
    None when ``model.eval_sdf_bake`` is "off"."""
    if getattr(model, "eval_sdf_bake", "off") == "off":
        return None
    return bake_packed(lambda p: model.geometry.sdf(p, step),
                       model.aabb_min, model.aabb_max,
                       model.eval_sdf_bake_cells)


def _cell_coords(pos, aabb_min, aabb_max, cells):
    u = (pos - aabb_min) / (aabb_max - aabb_min) * cells
    i = torch.clamp(torch.floor(u).to(torch.int32), 0, cells - 1)
    f = torch.clamp(u - i.to(u.dtype), 0.0, 1.0)
    return i, f


def _rows(bake, i):
    """The packed row of each sample's cell: one G1 gather on the card."""
    v = bake["cells"] + 1
    flat = (i[..., 0] * v + i[..., 1]) * v + i[..., 2]
    return gather_rows(bake["packed"], flat.reshape(-1)).view(
        *flat.shape, 8)


def _corner_weights(f):
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    w = [(fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
         * (fz if dz else 1.0 - fz) for dx, dy, dz in _CORNERS]
    return torch.stack(w, -1)  # [..., 8]


def sample_packed(bake, pos, aabb_min, aabb_max):
    """Trilinear SDF at world ``pos`` [N, 3] from a packed bake -> [N]."""
    i, f = _cell_coords(pos, aabb_min, aabb_max, bake["cells"])
    return torch.sum(_rows(bake, i) * _corner_weights(f), -1)


def sample_packed_grad(bake, pos, aabb_min, aabb_max):
    """Trilinear SDF and the gradient of the interpolant in its cell,
    in world units -> ``(sdf [N], grad [N, 3])``."""
    cells = bake["cells"]
    extent = aabb_max - aabb_min
    i, f = _cell_coords(pos, aabb_min, aabb_max, cells)
    rows = _rows(bake, i)
    sdf = torch.sum(rows * _corner_weights(f), -1)
    grads = []
    for axis in range(3):
        dw = []
        for corner in _CORNERS:
            term = torch.ones_like(f[..., axis]) if corner[axis] \
                else -torch.ones_like(f[..., axis])
            for other in range(3):
                if other != axis:
                    fo = f[..., other]
                    term = term * (fo if corner[other] else 1.0 - fo)
            dw.append(term)
        grads.append(torch.sum(rows * torch.stack(dw, -1), -1)
                     * (float(cells) / extent[axis]))
    return sdf, torch.stack(grads, -1)
