"""Volume-rendering scan and accumulation on compacted sample buffers
(counterpart of ``rise_sdf_tpu/ops/volrend.py``).

The per-ray transmittance scan is one cumulative sum of ``log(1 -
alpha)`` over the ray-major buffer with each ray's start offset
subtracted (a segmented exclusive scan); accumulation sums into an
``n_rays + 1`` buffer whose last row takes the dead slots.  The
visibility prefilter reads the same scan: ``transmittance_cut`` and
``transmittance_band`` reduce it to a per-ray distance (a segment
minimum, ``scatter_reduce`` with ``amin``).
"""

from __future__ import annotations

from typing import Optional

import torch

# transmittance below this is treated as opaque-terminated, matching
# nerfacc's early_stop_eps used by OccGridEstimator.sampling
EARLY_STOP_EPS = 1e-4


def render_weight_from_alpha(alphas, ray_start, ray_indices, valid,
                             n_rays: int):
    """Per-sample weights ``w_i = T_i * alpha_i`` on a compacted buffer.

    alphas: [C] in [0,1]; ray_start: [R] buffer offset of each ray's first
    sample; ray_indices: [C] (== n_rays for dead slots); valid: [C] bool.
    Returns (weights [C], trans [C]), ``trans`` being the transmittance
    *before* each sample within its ray.
    """
    a = torch.where(valid, torch.clamp(alphas, 0.0, 1.0 - 1e-7), 0.0)
    c = torch.cumsum(torch.log1p(-a), 0)
    c_prev = torch.cat([c.new_zeros(1), c[:-1]])  # exclusive
    # cumulative log-transmittance at the start of each ray.  Gathers go
    # through index_select: its backward is an atomic index_add_, where
    # advanced indexing's backward sorts the 1M indices first
    ray_start_cl = torch.clamp(ray_start, 0, max(a.shape[0] - 1, 0))
    start_c = torch.where(ray_start == 0, 0.0,
                          c_prev.index_select(0, ray_start_cl))
    per_sample_start = torch.cat([start_c, c.new_zeros(1)]).index_select(
        0, torch.clamp(ray_indices, max=n_rays))
    trans = torch.exp(c_prev - per_sample_start)
    weights = trans * a
    return torch.where(valid, weights, 0.0), torch.where(valid, trans, 0.0)


def accumulate_along_rays(weights, ray_indices, values: Optional[torch.Tensor],
                          n_rays: int):
    """Sum_i w_i * v_i per ray. values: [C, D] or None (opacity)."""
    src = weights[:, None] if values is None else weights[:, None] * values
    out = src.new_zeros((n_rays + 1, src.shape[1]))
    return out.index_add(0, ray_indices, src)[:n_rays]


def render_visibility(alphas, ray_start, ray_indices, valid, n_rays: int,
                      early_stop_eps: float = EARLY_STOP_EPS,
                      alpha_thre: float = 0.0):
    """Visible-sample mask: the transmittance before the sample is at
    least ``early_stop_eps`` and, when ``alpha_thre > 0``, its alpha at
    least ``alpha_thre``."""
    _, trans = render_weight_from_alpha(alphas, ray_start, ray_indices,
                                        valid, n_rays)
    vis = valid & (trans >= early_stop_eps)
    if alpha_thre > 0:
        vis = vis & (alphas >= alpha_thre)
    return vis


def _segment_min(vals, ray_indices, n_rays: int, fill: float):
    """Per-ray minimum of ``vals`` [C] (``fill`` for rays without
    samples); dead slots (``ray_indices == n_rays``) land in a spare row."""
    out = torch.full((n_rays + 1,), fill, dtype=vals.dtype,
                     device=vals.device)
    idx = torch.clamp(ray_indices, max=n_rays)
    return out.scatter_reduce(0, idx, vals, reduce="amin")[:n_rays]


def transmittance_cut(alphas, t_starts, ray_start, ray_indices, valid,
                      n_rays: int, early_stop_eps: float = EARLY_STOP_EPS,
                      margin: float = 0.0):
    """Per-ray visibility cut: the ``t_start`` of the first sample whose
    transmittance before it drops below ``early_stop_eps``, plus
    ``margin``; 1e10 (no cut) for rays that never saturate or have no
    samples in the buffer."""
    _, trans = render_weight_from_alpha(alphas, ray_start, ray_indices,
                                        valid, n_rays)
    inf = 1e10
    crossed_t = torch.where(valid & (trans < early_stop_eps), t_starts, inf)
    cut = _segment_min(crossed_t, ray_indices, n_rays, inf)
    return torch.clamp(cut + margin, max=inf)


def transmittance_band(alphas, t_starts, ray_start, ray_indices, valid,
                       n_rays: int, early_stop_eps: float = EARLY_STOP_EPS,
                       enter_eps: Optional[float] = None,
                       margin: float = 0.0):
    """Per-ray weight-mass band ``(t_lo, t_cut)``: ``t_cut`` as
    :func:`transmittance_cut`, ``t_lo`` the ``t_start`` of the first
    sample whose weight exceeds ``enter_eps`` (default
    ``early_stop_eps``) minus ``margin``, or -1e10 (no lower bound) for
    rays that never enter."""
    weights, trans = render_weight_from_alpha(alphas, ray_start,
                                              ray_indices, valid, n_rays)
    inf = 1e10
    crossed_t = torch.where(valid & (trans < early_stop_eps), t_starts, inf)
    cut = torch.clamp(_segment_min(crossed_t, ray_indices, n_rays, inf)
                      + margin, max=inf)
    ee = early_stop_eps if enter_eps is None else enter_eps
    entered_t = torch.where(valid & (weights > ee), t_starts, inf)
    lo = _segment_min(entered_t, ray_indices, n_rays, inf)
    lo = torch.where(lo >= inf, -inf, lo - margin)
    return lo, cut


def render_weight_from_alpha_dense(alphas, live):
    """Weights on a non-compacted ``[R, S]`` grid (secondary rays).
    Returns (weights [R, S], trans [R, S])."""
    a = torch.where(live, torch.clamp(alphas, 0.0, 1.0 - 1e-7), 0.0)
    c = torch.cumsum(torch.log1p(-a), 1)
    c_prev = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], 1)
    trans = torch.exp(c_prev)
    return trans * a, trans
