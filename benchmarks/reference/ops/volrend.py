"""Volume-rendering scan and accumulation on compacted sample buffers
(counterpart of ``rise_sdf_tpu/ops/volrend.py``).

The per-ray transmittance scan is one cumulative sum of ``log(1 -
alpha)`` over the ray-major buffer with each ray's start offset
subtracted (a segmented exclusive scan); accumulation sums into an
``n_rays + 1`` buffer whose last row takes the dead slots.  The
visibility prefilter reads the same scan: ``transmittance_cut`` and
``transmittance_band`` reduce it to a per-ray distance (a segment
minimum, ``scatter_reduce`` with ``amin``).

On CUDA both are nondeterministic as torch computes them: the scan of
a long vector is CUB's device-wide scan, whose decoupled look-back adds
the tiles' partial sums in an order that changes from run to run, and
``index_add`` adds with float atomics.  An eval render passes
``deterministic=True``: on the card the scan then runs in float64 in
two levels of row scans (``blocked_cumsum``), each row in one block in a
fixed order, and the accumulation is a sorted segment sum
(``sorted_segment_sum``, float64 prefix differences at the rays'
boundaries), so the same inputs give the same image on every run, and a
ray's image does not depend on where in the buffer it sits (a float32
running total rounds a ray's transmittance at the magnitude of the rays
before it).  On the CPU torch's scan and
``index_add`` are sequential and deterministic already and stay as
they are.  Training keeps the plain ops: its backward scatters with
atomics (K1 and the gathers' ``index_add_``).

Under ``torch.use_deterministic_algorithms(True)`` (on every device)
training takes the deterministic ops too: the scans are
``blocked_cumsum`` (the transmittance scan in float64, as eval's), the
accumulation ``sorted_segment_sum``, and every gather whose gradient is
taken goes through ``scatter_sorted.index_select``, whose backward is
the deterministic scatter K2 (``ops/scatter_sorted.py``), so a training
step repeats bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .scatter_sorted import index_select

# transmittance below this is treated as opaque-terminated, matching
# nerfacc's early_stop_eps used by OccGridEstimator.sampling
EARLY_STOP_EPS = 1e-4
# the row length of ``blocked_cumsum``'s first level
SCAN_BLOCK = 1024


def _scan_rows(x):
    """Inclusive scan along the last dim of a 2-D tensor.  torch scans
    the rows of a tensor of two or more rows each in one block, in a
    fixed order; a tensor of one row goes to the device-wide scan, so a
    single row gets a zero row beside it."""
    if x.shape[0] == 1:
        return torch.cat([x, torch.zeros_like(x)]).cumsum(1)[:1]
    return x.cumsum(1)


def blocked_cumsum(x, block: int = SCAN_BLOCK):
    """Inclusive scan of ``x`` [C] or [C, D] along dim 0, deterministic on
    every device: scans of ``block``-long rows, then of the row totals
    (exclusive), added back."""
    shape = x.shape
    cols = x.reshape(shape[0], -1).t()                  # [D, C]
    d, c = cols.shape
    m = max(-(-c // block), 1)
    rows = F.pad(cols, (0, m * block - c)).reshape(d * m, block)
    inner = _scan_rows(rows).reshape(d, m, block)
    tot = _scan_rows(inner[:, :, -1])                   # [D, m]
    off = F.pad(tot[:, :-1], (1, 0))
    out = (inner + off[..., None]).reshape(d, m * block)[:, :c]
    return out.t().reshape(shape)


def sorted_segment_sum(src, ray_indices, n_rays: int):
    """Per-ray sums of ``src`` [C, D] when ``ray_indices`` [C] is sorted
    (ray-major buffers; dead slots, ``n_rays``, at the end): float64
    prefix sums (``blocked_cumsum``) differenced at each ray's first and
    one-past-last slot (``searchsorted``), rounded to ``src``'s dtype.
    Deterministic on every device; a non-finite entry reaches the rays
    after its own, as it does in the transmittance scan."""
    bounds = torch.searchsorted(
        ray_indices, torch.arange(n_rays + 1, device=src.device,
                                  dtype=ray_indices.dtype))
    prefix = F.pad(blocked_cumsum(src.double()), (0, 0, 1, 0))
    return (index_select(prefix, bounds[1:])
            - index_select(prefix, bounds[:-1])).to(src.dtype)


def _use_deterministic(x, deterministic: bool) -> bool:
    """The deterministic ops: asked for on the card, or under torch's
    deterministic switch on any device."""
    return (deterministic and x.device.type != "cpu") \
        or torch.are_deterministic_algorithms_enabled()


def render_weight_from_alpha(alphas, ray_start, ray_indices, valid,
                             n_rays: int, deterministic: bool = False):
    """Per-sample weights ``w_i = T_i * alpha_i`` on a compacted buffer.

    alphas: [C] in [0,1]; ray_start: [R] buffer offset of each ray's first
    sample; ray_indices: [C] (== n_rays for dead slots); valid: [C] bool.
    Returns (weights [C], trans [C]), ``trans`` being the transmittance
    *before* each sample within its ray.  ``deterministic`` takes
    ``blocked_cumsum`` in float64 on the card, as the deterministic switch
    does on every device (module docstring).
    """
    a = torch.where(valid, torch.clamp(alphas, 0.0, 1.0 - 1e-7), 0.0)
    la = torch.log1p(-a)
    if _use_deterministic(la, deterministic):
        # float64: a ray's log-transmittance is a difference of two
        # running sums, which float32 would round at the buffer's running
        # total, so the result would depend on where the ray sits
        c = blocked_cumsum(la.double())
    else:
        c = torch.cumsum(la, 0)
    c_prev = torch.cat([c.new_zeros(1), c[:-1]])  # exclusive
    # cumulative log-transmittance at the start of each ray.  Gathers go
    # through index_select: its backward is an atomic index_add_ (K2
    # under the deterministic switch), where advanced indexing's backward
    # sorts the 1M indices first
    ray_start_cl = torch.clamp(ray_start, 0, max(a.shape[0] - 1, 0))
    start_c = torch.where(ray_start == 0, 0.0,
                          index_select(c_prev, ray_start_cl))
    per_sample_start = index_select(torch.cat([start_c, c.new_zeros(1)]),
                                    torch.clamp(ray_indices, max=n_rays))
    trans = torch.exp((c_prev - per_sample_start).to(a.dtype))
    weights = trans * a
    return torch.where(valid, weights, 0.0), torch.where(valid, trans, 0.0)


def accumulate_along_rays(weights, ray_indices, values: Optional[torch.Tensor],
                          n_rays: int, deterministic: bool = False):
    """Sum_i w_i * v_i per ray. values: [C, D] or None (opacity).
    ``deterministic`` takes ``sorted_segment_sum`` on the card."""
    src = weights[:, None] if values is None else weights[:, None] * values
    if _use_deterministic(src, deterministic):
        return sorted_segment_sum(src, ray_indices, n_rays)
    out = src.new_zeros((n_rays + 1, src.shape[1]))
    return out.index_add(0, ray_indices, src)[:n_rays]


def render_visibility(alphas, ray_start, ray_indices, valid, n_rays: int,
                      early_stop_eps: float = EARLY_STOP_EPS,
                      alpha_thre: float = 0.0, deterministic: bool = False):
    """Visible-sample mask: the transmittance before the sample is at
    least ``early_stop_eps`` and, when ``alpha_thre > 0``, its alpha at
    least ``alpha_thre``."""
    _, trans = render_weight_from_alpha(alphas, ray_start, ray_indices,
                                        valid, n_rays, deterministic)
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
                      margin: float = 0.0, deterministic: bool = False):
    """Per-ray visibility cut: the ``t_start`` of the first sample whose
    transmittance before it drops below ``early_stop_eps``, plus
    ``margin``; 1e10 (no cut) for rays that never saturate or have no
    samples in the buffer."""
    _, trans = render_weight_from_alpha(alphas, ray_start, ray_indices,
                                        valid, n_rays, deterministic)
    inf = 1e10
    crossed_t = torch.where(valid & (trans < early_stop_eps), t_starts, inf)
    cut = _segment_min(crossed_t, ray_indices, n_rays, inf)
    return torch.clamp(cut + margin, max=inf)


def transmittance_band(alphas, t_starts, ray_start, ray_indices, valid,
                       n_rays: int, early_stop_eps: float = EARLY_STOP_EPS,
                       enter_eps: Optional[float] = None,
                       margin: float = 0.0, deterministic: bool = False):
    """Per-ray weight-mass band ``(t_lo, t_cut)``: ``t_cut`` as
    :func:`transmittance_cut`, ``t_lo`` the ``t_start`` of the first
    sample whose weight exceeds ``enter_eps`` (default
    ``early_stop_eps``) minus ``margin``, or -1e10 (no lower bound) for
    rays that never enter."""
    weights, trans = render_weight_from_alpha(alphas, ray_start,
                                              ray_indices, valid, n_rays,
                                              deterministic)
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
    c = _scan_rows(torch.log1p(-a))
    c_prev = torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1]], 1)
    trans = torch.exp(c_prev)
    return trans * a, trans


def distortion_loss(weights, t_mids, intervals, ray_indices, ray_start,
                    valid, n_rays: int):
    """Mip-NeRF 360's distortion loss summed over the rays of a
    compacted buffer: per ray ``sum_ij w_i w_j |m_i - m_j| + (1/3)
    sum_i w_i^2 d_i`` (``flatten_eff_distloss``), in O(n) through
    ``sum_ij w_i w_j |m_i - m_j| = 2 sum_i w_i (m_i W_i - M_i)``, where
    ``W_i`` and ``M_i`` are the exclusive in-ray prefix sums of ``w``
    and ``w m``; a ray's samples sit in ascending ``m`` in the buffer.

    The prefix sums are one ``cumsum`` over the whole buffer with each
    ray's start subtracted, as the transmittance scan of a training step
    (``render_weight_from_alpha``).  On the CPU (the plain version, as
    JAX computes it) the scan is float32 and carries the same caveat: a
    ray's sums are differences of two running totals, rounded at the
    buffer's running magnitude (``ROADMAP.md``, Queue 3).  On the card
    it runs in float64: in float32 the term of a 4096-ray step at
    ``neus_colmap`` widths came out 8.6e-5 (relative) from a float64
    double sum (``chip_smoke.py`` phase 13d, ``PERF.md``).  Under the
    deterministic switch the scan is ``blocked_cumsum`` in the same
    dtype."""
    w = torch.where(valid, weights, 0.0)
    last = max(w.shape[0] - 1, 0)
    start = torch.clamp(ray_start, 0, last)
    idx = torch.clamp(ray_indices, max=n_rays)
    scan_dtype = w.dtype if w.device.type == "cpu" else torch.float64
    scan = blocked_cumsum if torch.are_deterministic_algorithms_enabled() \
        else (lambda x: torch.cumsum(x, 0))

    def in_ray_exclusive(x):
        c = scan(x.to(scan_dtype))
        c_prev = torch.cat([c.new_zeros(1), c[:-1]])
        start_c = torch.where(ray_start == 0, 0.0,
                              index_select(c_prev, start))
        return (c_prev - index_select(torch.cat([start_c, c.new_zeros(1)]),
                                      idx)).to(x.dtype)

    sw = in_ray_exclusive(w)
    swm = in_ray_exclusive(w * t_mids)
    cross = 2.0 * (w * (t_mids * sw - swm))
    self_term = (w * w * torch.where(valid, intervals, 0.0)) / 3.0
    return torch.sum(torch.where(valid, cross + self_term, 0.0))
