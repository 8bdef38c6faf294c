"""Eval helpers (counterpart of ``rise_sdf_tpu/utils/misc.py``)."""

from __future__ import annotations

import numpy as np


def scale_anything(x, in_range, out_range):
    """Map ``x`` linearly from ``in_range`` onto ``out_range``."""
    lo, hi = in_range
    olo, ohi = out_range
    return (x - lo) / (hi - lo) * (ohi - olo) + olo


def interleave_order(n: int, chunk: int, mode):
    """Deterministic eval-ray interleave permutation and its inverse.

    Silhouette rays cluster in space, so row-major chunks concentrate the
    sample load in a few chunks; interleaving spreads every chunk's load
    toward the mean, so a fixed per-chunk sample buffer drops fewer rays.
    Per-ray results do not depend on the order: rendering through
    ``order`` and gathering back through ``inv`` leaves the image as it
    is.

    ``mode``: falsy or ``"off"`` -> ``(None, None)``; ``"golden"`` (also
    ``True``) -> the multiplicative stride ``i * p % n`` with ``p`` the
    first integer from ``floor(0.618... * n)`` up that is coprime to
    ``n``; ``"strided"`` -> the transpose of the (n_chunks, chunk) index
    grid.
    """
    if not mode or mode == "off":
        return None, None
    if n <= chunk:
        return None, None
    if mode == "strided":
        nc = -(-n // chunk)
        order = np.arange(nc * chunk).reshape(nc, chunk).T.reshape(-1)
        order = order[order < n]
    else:
        p = int(n * 0.6180339887498949) or 1
        while np.gcd(p, n) != 1:
            p += 1
        order = (np.arange(n, dtype=np.int64) * p) % n
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    return order, inv
