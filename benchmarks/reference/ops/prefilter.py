"""Environment-map prefiltering as precomputed linear operators
(counterpart of ``rise_sdf_tpu/ops/prefilter.py``).

The filter construction is a copy of the JAX package's numpy code: both
filters are linear in the input cubemap with weights that depend only on
(resolution, roughness), so they are built once on the host.

* Diffuse (cosine) filtering at 16^2: a dense ``[1536, 1536]`` matrix.
* GGX specular filtering of each mip level at a working resolution M
  (the 99%-energy GGX cone spans a few texels), read from the avg-pool
  mip chain, then bilinearly upsampled to the level's resolution; dense
  for wide kernels, ``[T, K]`` sparse (index, weight) otherwise.

The bank is cached as ``.npz`` under the package's git-ignored
``_cache/`` directory.  ``apply_diffuse_filter`` and
``apply_specular_level_filter`` apply the filters in torch (a matmul, or
a gather and a weighted sum), on the filters' torch copies made by
``to_torch``.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cubemap import face_directions, sample_cubemap
from .scatter_sorted import index_select

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_cache")

MIN_ROUGHNESS = 0.08
MAX_ROUGHNESS = 0.5
LIGHT_MIN_RES = 16


def _np_face_dirs(res: int) -> np.ndarray:
    """Texel directions in float64, [6 res^2, 3]."""
    g = (np.arange(res, dtype=np.float64) + 0.5) / res * 2.0 - 1.0
    v, u = np.meshgrid(g, g, indexing="ij")
    one = np.ones_like(u)
    faces = [
        np.stack([one, -v, -u], -1), np.stack([-one, -v, u], -1),
        np.stack([u, one, v], -1), np.stack([u, -one, -v], -1),
        np.stack([u, -v, one], -1), np.stack([-u, -v, -one], -1),
    ]
    dirs = np.stack(faces, 0)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.reshape(-1, 3)


def _np_areas(res: int) -> np.ndarray:
    """Pure-numpy per-texel solid angles, tiled over the 6 faces."""
    def integrate(x, y):
        return np.arctan2(x * y, np.sqrt(x * x + y * y + 1.0))

    e = np.linspace(-1.0, 1.0, res + 1)
    x0, x1 = e[:-1][:, None], e[1:][:, None]
    y0, y1 = e[:-1][None, :], e[1:][None, :]
    a = (integrate(x1, y1) - integrate(x0, y1)
         - integrate(x1, y0) + integrate(x0, y0))
    return np.tile(a[None], (6, 1, 1)).reshape(-1)


def ndf_ggx(alpha_sqr: np.ndarray, cos_theta: np.ndarray) -> np.ndarray:
    c = np.clip(cos_theta, 0.0, 1.0)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * np.pi)


def ggx_cutoff_costheta(roughness: float, cutoff: float = 0.99) -> float:
    """99%-energy cutoff angle, numerically like reference ops.py:428-443."""
    n = 100000
    costheta = np.cos(np.linspace(0, np.pi / 2.0, n))
    d = np.cumsum(ndf_ggx(roughness ** 4, costheta))
    idx = int(np.argmax(d >= d[-1] * cutoff))
    return float(costheta[idx])


@lru_cache(maxsize=8)
def diffuse_filter_matrix(res: int = LIGHT_MIN_RES) -> np.ndarray:
    """[6res^2, 6res^2] cosine-hemisphere filter (cubemap.cu diffuse fwd)."""
    dirs = _np_face_dirs(res)
    areas = _np_areas(res)
    dots = np.clip(dirs @ dirs.T, 0.0, 0.999)
    w = dots * areas[None, :] / np.pi
    return w.astype(np.float32)


class SpecularLevelFilter(NamedTuple):
    """Precomputed GGX filter for one mip level."""

    target_res: int           # output resolution N
    work_res: int             # filtering resolution M (input from mip chain)
    dense: Optional[np.ndarray]   # [T,T] if dense mode
    idx: Optional[np.ndarray]     # [T,K] int32 if sparse mode
    w: Optional[np.ndarray]       # [T,K] float32


MAX_WORK_RES = 128  # precompute is O(T^2); 128^2*6 rows is the practical cap


def _choose_work_res(target_res: int, theta_c: float,
                     max_radius_texels: float = 8.0) -> int:
    """Largest power-of-two resolution where the cone spans <= ~8 texels.

    Cone radius in texels at resolution M is ~ theta_c / ((pi/2)/M), so we
    require M <= max_radius * pi / (2 * theta_c), capped at MAX_WORK_RES.
    At the MAX_WORK_RES cap the sharpest ladder level (roughness 0.08,
    theta_c ~ 0.022) still spans ~1.8 texels -> ~10-texel support.
    """
    if theta_c <= 1e-6:
        return min(target_res, MAX_WORK_RES)
    m_max = max_radius_texels * math.pi / (2.0 * theta_c)
    res = LIGHT_MIN_RES
    while res * 2 <= min(target_res, MAX_WORK_RES, int(m_max)):
        res *= 2
    return max(LIGHT_MIN_RES, min(res, target_res, MAX_WORK_RES))


def _specular_weights_rows(dirs, areas, rows, alpha_sqr, costheta_c):
    """Normalized filter weights for a block of output texels. [B, T].

    With |L| = |V| = 1, dot(V, H) = dot(V, (L+V)/|L+V|) =
    (1 + dot(L,V)) / sqrt(2 + 2 dot(L,V)) = sqrt((1 + dot(L,V)) / 2),
    so the whole kernel is a function of the single dot-product matrix.
    """
    v = dirs[rows]                                   # [B,3]
    dots = v @ dirs.T                                # [B,T] dot(L, VNR)
    vnr_dot_h = np.sqrt(np.clip((1.0 + dots) / 2.0, 0.0, 1.0))
    w = np.maximum(dots, 0.0) * ndf_ggx(alpha_sqr, vnr_dot_h) * areas[None, :] / 4.0
    mask = dots >= costheta_c
    mask[np.arange(len(rows)), rows] = True  # center texel always kept
    w = np.where(mask, w, 0.0)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-20)
    return w.astype(np.float32), mask


def build_specular_level_filter(target_res: int,
                                roughness: float,
                                cutoff: float = 0.99) -> SpecularLevelFilter:
    costheta_c = ggx_cutoff_costheta(roughness, cutoff)
    theta_c = math.acos(min(max(costheta_c, -1.0), 1.0))
    work_res = _choose_work_res(target_res, theta_c)
    # NO stencil floor beyond the exact cutoff: the NDF is evaluated at
    # the HALF angle (dot(V,H) with H = normalize(L+V)), so its tail
    # decays only ~quartically in L-angle — widening the mask past the
    # reference's 99%-energy cutoff pulled in ~20% spurious tail mass
    # (measured vs the brute-force cubemap.cu oracle,
    # tests/test_prefilter_oracle.py).  When the cone is sub-texel at
    # work_res the filter degenerates toward identity, exactly like the
    # reference kernel at that resolution (support = the center texel).

    dirs = _np_face_dirs(work_res).astype(np.float32)
    areas = _np_areas(work_res).astype(np.float32)
    alpha = roughness * roughness
    alpha_sqr = alpha * alpha
    t = dirs.shape[0]
    theta_eff = math.acos(min(max(costheta_c, -1.0), 1.0))

    if work_res <= LIGHT_MIN_RES or theta_eff > 0.9:
        # wide kernels at low res: dense matrix
        w_full, _ = _specular_weights_rows(dirs, areas, np.arange(t),
                                           alpha_sqr, costheta_c)
        return SpecularLevelFilter(target_res, work_res, w_full, None, None)

    # sparse path with geometric candidate pruning: process rows in small
    # spatial tiles; only columns within (theta_c + tile radius) of the
    # tile centroid can be in any row's stencil.  Keeps temporaries tiny.
    tile = max(work_res // 8, 4)                    # tile x tile rows per face
    rows_blocks = []
    t_per_face = work_res * work_res
    for f in range(6):
        for ty in range(0, work_res, tile):
            for tx in range(0, work_res, tile):
                yy, xx = np.meshgrid(np.arange(ty, ty + tile),
                                     np.arange(tx, tx + tile), indexing="ij")
                rows_blocks.append(f * t_per_face + (yy * work_res + xx).reshape(-1))

    # pass 1: nnz bound from one representative block per face region is
    # not safe; compute per block but cheaply on the pruned columns
    entries_idx = np.zeros((t,), object)
    entries_w = np.zeros((t,), object)
    nnz = 1
    for rows in rows_blocks:
        v = dirs[rows]
        centroid = v.mean(0)
        centroid /= max(np.linalg.norm(centroid), 1e-9)
        cos_tile = float(np.min(v @ centroid))       # cos of tile radius
        theta_tile = math.acos(min(max(cos_tile, -1.0), 1.0))
        cand_cut = math.cos(min(theta_eff + theta_tile + 0.05, math.pi))
        cand = np.nonzero(dirs @ centroid >= cand_cut)[0]
        dots = v @ dirs[cand].T                      # [B, C] small
        vnr_dot_h = np.sqrt(np.clip((1.0 + dots) / 2.0, 0.0, 1.0))
        w = np.maximum(dots, 0.0) * ndf_ggx(alpha_sqr, vnr_dot_h) \
            * areas[cand][None, :] / 4.0
        mask = dots >= costheta_c
        # keep the center texel of each row
        center_local = np.searchsorted(cand, rows)
        ok = (center_local < len(cand)) & (cand[np.minimum(
            center_local, len(cand) - 1)] == rows)
        mask[np.arange(len(rows))[ok], center_local[ok]] = True
        w = np.where(mask, w, 0.0)
        w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-20)
        nnz = max(nnz, int(mask.sum(axis=1).max()))
        for i, r in enumerate(rows):
            nz = np.nonzero(mask[i])[0]
            entries_idx[r] = cand[nz].astype(np.int32)
            entries_w[r] = w[i, nz].astype(np.float32)

    idx_arr = np.zeros((t, nnz), np.int32)
    w_arr = np.zeros((t, nnz), np.float32)
    for r in range(t):
        k = len(entries_idx[r])
        idx_arr[r, :k] = entries_idx[r]
        w_arr[r, :k] = entries_w[r]
    # numpy payloads: safe to cache regardless of trace context
    return SpecularLevelFilter(target_res, work_res, None, idx_arr, w_arr)


class TorchLevelFilter(NamedTuple):
    """A ``SpecularLevelFilter``'s arrays as tensors on one device."""

    target_res: int
    work_res: int
    dense: Optional[torch.Tensor]   # [T, T]
    idx: Optional[torch.Tensor]     # [T, K] int64
    w: Optional[torch.Tensor]       # [T, K]


def to_torch(filt: SpecularLevelFilter, device,
             dtype=torch.float32) -> TorchLevelFilter:
    """The filter's arrays on ``device``, weights in ``dtype``."""
    def t(a, dt):
        return None if a is None else torch.as_tensor(a, dtype=dt,
                                                      device=device)

    return TorchLevelFilter(filt.target_res, filt.work_res,
                            t(filt.dense, dtype), t(filt.idx, torch.int64),
                            t(filt.w, dtype))


def apply_diffuse_filter(cubemap: torch.Tensor,
                         matrix: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Cosine-filter a ``[6, res, res, C]`` cubemap; ``matrix`` is
    ``diffuse_filter_matrix(res)`` as a tensor (made here if not given)."""
    res = cubemap.shape[1]
    if matrix is None:
        matrix = torch.as_tensor(diffuse_filter_matrix(res),
                                 device=cubemap.device)
    out = matrix @ cubemap.reshape(6 * res * res, -1)
    return out.reshape(6, res, res, -1)


def apply_specular_level_filter(filt: TorchLevelFilter,
                                chain: List[torch.Tensor]) -> torch.Tensor:
    """Filter using the mip ``chain`` (chain[i] has res base/2^i)."""
    base_res = chain[0].shape[1]
    ci = int(round(math.log2(base_res / filt.work_res)))
    m = filt.work_res
    flat = chain[ci].reshape(6 * m * m, -1)
    if filt.dense is not None:
        out = (filt.dense @ flat).reshape(6, m, m, -1)
    else:
        gathered = index_select(flat, filt.idx.reshape(-1)).view(
            *filt.idx.shape, flat.shape[1])            # [T, K, C]
        out = torch.einsum("tk,tkc->tc", filt.w, gathered).reshape(
            6, m, m, -1)
    if m == filt.target_res:
        return out
    return sample_cubemap(out, face_directions(filt.target_res,
                                               device=out.device))


def _bank_cache_path(base_res: int, cutoff: float) -> str:
    os.makedirs(CACHE_DIR, exist_ok=True)
    return os.path.join(CACHE_DIR, f"prefilter_v2_{base_res}_{cutoff}.npz")


@lru_cache(maxsize=4)
def build_specular_filter_bank(base_res: int, cutoff: float = 0.99
                               ) -> Tuple[SpecularLevelFilter, ...]:
    """Filters for the full mip ladder of a ``base_res`` cubemap.

    Ladder matches reference ``lib/pbr/light.py:169-180``: levels at
    base_res .. 16 with roughness ramp MIN..MAX over levels [0, n-2] and
    roughness 1.0 at the last level.
    """
    cache = _bank_cache_path(base_res, cutoff)
    if os.path.exists(cache):
        data = np.load(cache, allow_pickle=False)
        n = int(data["n_levels"])
        filters = []
        for i in range(n):
            dense = data[f"dense_{i}"] if f"dense_{i}" in data else None
            idx = data[f"idx_{i}"] if f"idx_{i}" in data else None
            w = data[f"w_{i}"] if f"w_{i}" in data else None
            filters.append(SpecularLevelFilter(
                int(data[f"target_{i}"]), int(data[f"work_{i}"]),
                dense, idx, w))
        return tuple(filters)

    resolutions = []
    r = base_res
    while r >= LIGHT_MIN_RES:
        resolutions.append(r)
        if r == LIGHT_MIN_RES:
            break
        r //= 2
    n = len(resolutions)
    filters = []
    for idx in range(n - 1):
        rough = (idx / max(n - 2, 1)) * (MAX_ROUGHNESS - MIN_ROUGHNESS) + MIN_ROUGHNESS
        filters.append(build_specular_level_filter(resolutions[idx], rough, cutoff))
    filters.append(build_specular_level_filter(resolutions[-1], 1.0, cutoff))

    payload = {"n_levels": np.asarray(len(filters))}
    for i, f in enumerate(filters):
        payload[f"target_{i}"] = np.asarray(f.target_res)
        payload[f"work_{i}"] = np.asarray(f.work_res)
        if f.dense is not None:
            payload[f"dense_{i}"] = f.dense
        else:
            payload[f"idx_{i}"] = f.idx
            payload[f"w_{i}"] = f.w
    tmp = f"{cache}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, cache)
    return tuple(filters)
