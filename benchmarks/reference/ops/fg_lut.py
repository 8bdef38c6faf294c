"""Pre-integrated split-sum BRDF table (FG / environment BRDF), a copy of
the numpy integration in ``rise_sdf_tpu/ops/fg_lut.py``.

``lut[row, col]``: col -> NoV in [0, 1], row -> roughness in [0, 1],
channels (A, B) so that ``specular_ref = F0 * A + B``.  Karis split sum
with GGX importance sampling (Hammersley points) and the Smith IBL
visibility term.  Computed once and cached as ``.npy`` under the
package's git-ignored ``_cache/`` directory.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

CACHE_DIR = Path(__file__).resolve().parent.parent / "_cache"
_MEMO = {}


def _hammersley(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << np.uint32(16)) | (bits >> np.uint32(16))) \
        & np.uint32(0xFFFFFFFF)
    bits = ((bits & np.uint32(0x55555555)) << np.uint32(1)) | \
           ((bits & np.uint32(0xAAAAAAAA)) >> np.uint32(1))
    bits = ((bits & np.uint32(0x33333333)) << np.uint32(2)) | \
           ((bits & np.uint32(0xCCCCCCCC)) >> np.uint32(2))
    bits = ((bits & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | \
           ((bits & np.uint32(0xF0F0F0F0)) >> np.uint32(4))
    bits = ((bits & np.uint32(0x00FF00FF)) << np.uint32(8)) | \
           ((bits & np.uint32(0xFF00FF00)) >> np.uint32(8))
    return np.stack([i.astype(np.float64) / n,
                     bits.astype(np.float64) * 2.3283064365386963e-10],
                    axis=-1)


def integrate_fg(n_o_v: np.ndarray, roughness: np.ndarray,
                 n_samples: int = 512) -> np.ndarray:
    """A/B terms for arrays of NoV [M] and roughness [M] -> [M, 2]."""
    nov = np.clip(n_o_v, 1e-4, 1.0)[:, None]
    rough = np.clip(roughness, 1e-3, 1.0)[:, None]
    alpha = rough ** 2

    xi = _hammersley(n_samples)[None, :, :]  # [1, S, 2]
    # GGX importance sample in tangent space (N = +z)
    phi = 2.0 * np.pi * xi[..., 0]
    cos_h = np.sqrt((1.0 - xi[..., 1]) /
                    (1.0 + (alpha ** 2 - 1.0) * xi[..., 1]))
    sin_h = np.sqrt(np.maximum(1.0 - cos_h ** 2, 0.0))
    hx, hz = sin_h * np.cos(phi), cos_h

    vx = np.sqrt(np.maximum(1.0 - nov ** 2, 0.0))
    v_dot_h = vx * hx + nov * hz
    # L = reflect(-V, H) = 2 (V.H) H - V
    lz = 2.0 * v_dot_h * hz - nov
    nol = np.clip(lz, 0.0, 1.0)
    noh = np.clip(hz, 0.0, 1.0)
    voh = np.clip(v_dot_h, 0.0, 1.0)

    # Smith GGX visibility for IBL (Karis: k = alpha / 2, alpha = rough^2)
    k = alpha / 2.0
    g_v = nov / (nov * (1.0 - k) + k)
    g_l = nol / (nol * (1.0 - k) + k)
    g_vis = np.where(nol > 0, g_v * g_l * voh / np.maximum(noh * nov, 1e-8),
                     0.0)
    fc = (1.0 - voh) ** 5
    a = ((1.0 - fc) * g_vis).mean(axis=1)
    b = (fc * g_vis).mean(axis=1)
    return np.stack([a, b], axis=-1)


def fg_lut(res: int = 256) -> np.ndarray:
    """[res, res, 2] float32; row -> roughness, col -> NoV."""
    if res in _MEMO:
        return _MEMO[res]
    path = CACHE_DIR / f"fg_lut_v2_{res}.npy"
    if path.exists():
        lut = np.load(path)
    else:
        nov = (np.arange(res) + 0.5) / res
        rough = (np.arange(res) + 0.5) / res
        nn, rr = np.meshgrid(nov, rough, indexing="xy")  # col=NoV, row=rough
        nn, rr = nn.reshape(-1), rr.reshape(-1)
        # entries are independent: 4096 at a time keeps the [M, 512]
        # temporaries at 16 MB
        lut = np.concatenate([
            integrate_fg(nn[s:s + 4096], rr[s:s + 4096])
            for s in range(0, nn.shape[0], 4096)]).reshape(
            res, res, 2).astype(np.float32)
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp.npy")
        np.save(tmp, lut)
        os.replace(tmp, path)
    _MEMO[res] = lut.astype(np.float32)
    return _MEMO[res]
