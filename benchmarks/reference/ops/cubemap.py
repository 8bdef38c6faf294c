"""Cubemap sampling and mip pyramids (counterpart of
``rise_sdf_tpu/ops/cubemap.py``).

Cubemaps are ``[6, N, N, C]``.  Face/uv conventions (nvdiffrast's cube
directions):

  face 0: +x  (u -> -z, v -> -y)      face 3: -y  (u -> +x, v -> -z)
  face 1: -x  (u -> +z, v -> -y)      face 4: +z  (u -> +x, v -> -y)
  face 2: +y  (u -> +x, v -> +z)      face 5: -z  (u -> -x, v -> -y)

Bilinear filtering is face-local with clamped uv, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .scatter_sorted import index_select


def _rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat[idx]`` for a ``[M, C]`` table and any-shaped ``idx`` (its
    backward K2 under the deterministic switch)."""
    return index_select(flat, idx.reshape(-1)).view(*idx.shape,
                                                    flat.shape[1])


def cube_to_dir(face: int, u, v):
    """Texel centre (u, v in [-1, 1]) on ``face`` -> unnormalised direction."""
    one = torch.ones_like(u)
    if face == 0:
        return torch.stack([one, -v, -u], -1)
    if face == 1:
        return torch.stack([-one, -v, u], -1)
    if face == 2:
        return torch.stack([u, one, v], -1)
    if face == 3:
        return torch.stack([u, -one, -v], -1)
    if face == 4:
        return torch.stack([u, -v, one], -1)
    if face == 5:
        return torch.stack([-u, -v, -one], -1)
    raise ValueError(face)


def face_directions(res: int, device=None) -> torch.Tensor:
    """[6, res, res, 3] unit directions of all texel centres (float32)."""
    g = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) \
        / res * 2.0 - 1.0
    v, u = torch.meshgrid(g, g, indexing="ij")
    dirs = torch.stack([cube_to_dir(s, u, v) for s in range(6)], 0)
    return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)


def dir_to_face_uv(dirs):
    """Directions [..., 3] -> (face [...] int64, u [...], v [...]), u and
    v in [-1, 1]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    zero = torch.zeros_like(x, dtype=torch.int64)
    face = torch.where(
        is_x, torch.where(x >= 0, zero, zero + 1),
        torch.where(is_y, torch.where(y >= 0, zero + 2, zero + 3),
                    torch.where(z >= 0, zero + 4, zero + 5)))
    m = torch.where(is_x, ax, torch.where(is_y, ay, az))
    m = torch.clamp(m, min=1e-12)
    u = torch.where(is_x, torch.where(x >= 0, -z, z),
                    torch.where(is_y, x, torch.where(z >= 0, x, -x))) / m
    v = torch.where(is_x, -y,
                    torch.where(is_y, torch.where(y >= 0, z, -z), -y)) / m
    return face, u, v


def sample_cubemap(cubemap, dirs):
    """Bilinear cubemap lookup. cubemap: [6, N, N, C]; dirs: [..., 3]."""
    res = cubemap.shape[1]
    face, u, v = dir_to_face_uv(dirs)
    fu = (u * 0.5 + 0.5) * res - 0.5
    fv = (v * 0.5 + 0.5) * res - 0.5
    u0 = torch.clamp(torch.floor(fu).long(), 0, res - 1)
    v0 = torch.clamp(torch.floor(fv).long(), 0, res - 1)
    u1 = torch.clamp(u0 + 1, 0, res - 1)
    v1 = torch.clamp(v0 + 1, 0, res - 1)
    wu = torch.clamp(fu - u0, 0.0, 1.0)[..., None]
    wv = torch.clamp(fv - v0, 0.0, 1.0)[..., None]
    flat = cubemap.reshape(6 * res * res, -1)

    def tap(vi, ui):
        return _rows(flat, (face * res + vi) * res + ui)

    top = tap(v0, u0) * (1 - wu) + tap(v0, u1) * wu
    bot = tap(v1, u0) * (1 - wu) + tap(v1, u1) * wu
    return top * (1 - wv) + bot * wv


def sample_cubemap_mips(mips: Sequence[torch.Tensor], dirs, mip_level):
    """Trilinear (bilinear x mip lerp) lookup over a mip pyramid
    ``mips`` [6, N_l, N_l, C] with ``mip_level`` [...] in [0, L - 1]:
    every level is sampled, then the two bracketing levels are blended
    (``sample_cubemap_mips_atlas`` gathers only those two)."""
    n_levels = len(mips)
    m = torch.clamp(mip_level, 0.0, n_levels - 1.0)
    l0 = torch.clamp(torch.floor(m).long(), 0, n_levels - 1)
    l1 = torch.clamp(l0 + 1, 0, n_levels - 1)
    frac = (m - l0.to(m.dtype))[..., None]
    samples = torch.stack([sample_cubemap(mp, dirs) for mp in mips], -1)

    def take(lvl):
        idx = lvl[..., None, None].expand(*lvl.shape, samples.shape[-2], 1)
        return torch.gather(samples, -1, idx)[..., 0]

    return take(l0) * (1 - frac) + take(l1) * frac


def mips_atlas(mips: Sequence[torch.Tensor]) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """A power-of-two mip pyramid flattened into one ``[sum 6 N_l^2, C]``
    table, and each level's row offset ``[L]`` (int64)."""
    c = mips[0].shape[-1]
    flat = torch.cat([m.reshape(-1, c) for m in mips], 0)
    sizes = [6 * m.shape[1] * m.shape[2] for m in mips]
    offsets = torch.tensor([0] + list(np.cumsum(sizes)[:-1]),
                           dtype=torch.int64, device=flat.device)
    return flat, offsets


def sample_cubemap_mips_atlas(mips: List[torch.Tensor], dirs, mip_level,
                              atlas=None):
    """Trilinear mip lookup (bilinear x mip lerp) through the flattened
    atlas: 8 taps per sample from the two bracketing levels.  ``atlas``
    is ``mips_atlas(mips)``, built here when not given."""
    n_levels = len(mips)
    base_res = mips[0].shape[1]
    flat, offsets = mips_atlas(mips) if atlas is None else atlas

    m = torch.clamp(mip_level, 0.0, n_levels - 1.0)
    l0 = torch.clamp(torch.floor(m).long(), 0, n_levels - 1)
    l1 = torch.clamp(l0 + 1, 0, n_levels - 1)
    frac = (m - l0.to(m.dtype))[..., None]
    face, u, v = dir_to_face_uv(dirs)

    def tap_level(lvl):
        res = torch.bitwise_right_shift(
            torch.full_like(lvl, base_res), lvl)        # base_res >> l
        resf = res.to(u.dtype)
        fu = (u * 0.5 + 0.5) * resf - 0.5
        fv = (v * 0.5 + 0.5) * resf - 0.5
        u0 = torch.minimum(torch.clamp(torch.floor(fu).long(), min=0),
                           res - 1)
        v0 = torch.minimum(torch.clamp(torch.floor(fv).long(), min=0),
                           res - 1)
        u1 = torch.minimum(u0 + 1, res - 1)
        v1 = torch.minimum(v0 + 1, res - 1)
        wu = torch.clamp(fu - u0, 0.0, 1.0)[..., None]
        wv = torch.clamp(fv - v0, 0.0, 1.0)[..., None]
        off = offsets[lvl]

        def tap(vi, ui):
            return _rows(flat, off + (face * res + vi) * res + ui)

        top = tap(v0, u0) * (1 - wu) + tap(v0, u1) * wu
        bot = tap(v1, u0) * (1 - wu) + tap(v1, u1) * wu
        return top * (1 - wv) + bot * wv

    return tap_level(l0) * (1 - frac) + tap_level(l1) * frac


def avg_pool_cubemap(cubemap):
    """2x2 average-pool mip reduction ([6,N,N,C] -> [6,N/2,N/2,C])."""
    f, n, _, c = cubemap.shape
    return cubemap.reshape(f, n // 2, 2, n // 2, 2, c).mean(dim=(2, 4))


def texel_solid_angle(res: int) -> torch.Tensor:
    """[res, res] solid angle of each texel (the same on every face)."""
    def integrate(x, y):
        return np.arctan2(x * y, np.sqrt(x * x + y * y + 1.0))

    e = np.linspace(-1.0, 1.0, res + 1)
    x0, x1 = e[:-1][:, None], e[1:][:, None]
    y0, y1 = e[:-1][None, :], e[1:][None, :]
    omega = (integrate(x1, y1) - integrate(x0, y1)
             - integrate(x1, y0) + integrate(x0, y0))
    return torch.from_numpy(omega.astype(np.float32))


def sample_texture2d(tex, uv):
    """Bilinear 2D lookup with clamped borders.  tex: [H, W, C]; uv:
    [..., 2] in [0, 1], u along W, v along H."""
    h, w = tex.shape[0], tex.shape[1]
    fu = torch.clamp(uv[..., 0], 0.0, 1.0) * w - 0.5
    fv = torch.clamp(uv[..., 1], 0.0, 1.0) * h - 0.5
    u0 = torch.clamp(torch.floor(fu).long(), 0, w - 1)
    v0 = torch.clamp(torch.floor(fv).long(), 0, h - 1)
    u1 = torch.clamp(u0 + 1, 0, w - 1)
    v1 = torch.clamp(v0 + 1, 0, h - 1)
    wu = torch.clamp(fu - u0, 0.0, 1.0)[..., None]
    wv = torch.clamp(fv - v0, 0.0, 1.0)[..., None]
    flat = tex.reshape(h * w, -1)

    def tap(vi, ui):
        return _rows(flat, vi * w + ui)

    top = tap(v0, u0) * (1 - wu) + tap(v0, u1) * wu
    bot = tap(v1, u0) * (1 - wu) + tap(v1, u1) * wu
    return top * (1 - wv) + bot * wv


# --------------------------------------------------------------------- #
# lat-long conversions (Blender and NMF conventions).  Lat-long images
# are [H, W, C].
# --------------------------------------------------------------------- #


def _sample_latlong(latlong, tu, tv):
    """Bilinear lookup of a lat-long image at (tu, tv) in [0, 1]: the
    azimuth wraps, the polar angle clamps."""
    h, w = latlong.shape[0], latlong.shape[1]
    fu = tu * w - 0.5
    fv = tv * h - 0.5
    u0 = torch.floor(fu).long()
    v0 = torch.clamp(torch.floor(fv).long(), 0, h - 1)
    v1 = torch.clamp(v0 + 1, 0, h - 1)
    wu = (fu - u0)[..., None]
    wv = (fv - v0)[..., None]
    u0w = torch.remainder(u0, w)
    u1w = torch.remainder(u0 + 1, w)
    flat = latlong.reshape(h * w, -1)

    def tap(vi, ui):
        return _rows(flat, vi * w + ui)

    top = tap(v0, u0w) * (1 - wu) + tap(v0, u1w) * wu
    bot = tap(v1, u0w) * (1 - wu) + tap(v1, u1w) * wu
    return top * (1 - wv) + bot * wv


def _latlong_uv(res: int, device, nmf: bool):
    dirs = face_directions(res, device)
    tu = torch.atan2(-dirs[..., 1], dirs[..., 0]) / (2 * math.pi) + 0.5
    if nmf:  # NMF mirrors the azimuth
        tu = torch.where(tu < 0.5, 0.5 - tu, 1.5 - tu)
    tv = torch.acos(torch.clamp(dirs[..., 2], -1, 1)) / math.pi
    return tu, tv


def blender_latlong_to_cubemap(latlong, res: int):
    """[H, W, C] lat-long (Blender convention) -> [6, res, res, C]."""
    return _sample_latlong(latlong, *_latlong_uv(res, latlong.device, False))


def nmf_latlong_to_cubemap(latlong, res: int):
    """[H, W, C] lat-long (NMF's mirrored azimuth) -> [6, res, res, C]."""
    return _sample_latlong(latlong, *_latlong_uv(res, latlong.device, True))


def _latlong_grid(out_hw, device):
    h, w = out_hw
    gy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    gx = ((torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w) \
        * 2.0 - 1.0
    gy, gx = torch.meshgrid(gy, gx, indexing="ij")
    return (torch.sin(gy * math.pi), torch.cos(gy * math.pi),
            torch.sin(gx * math.pi), torch.cos(gx * math.pi))


def cubemap_to_blender_latlong(cubemap, out_hw):
    """[6, N, N, C] -> [H, W, C] lat-long, Blender convention."""
    st, ct, sp, cp = _latlong_grid(out_hw, cubemap.device)
    return sample_cubemap(cubemap, torch.stack([st * cp, -st * sp, ct], -1))


def cubemap_to_latlong(cubemap, out_hw):
    """[6, N, N, C] -> [H, W, C] lat-long, y up (the envmap dumps)."""
    st, ct, sp, cp = _latlong_grid(out_hw, cubemap.device)
    return sample_cubemap(cubemap, torch.stack([st * sp, ct, -st * cp], -1))
