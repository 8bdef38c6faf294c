"""Occupancy-pruned ray marching compacted into a fixed-capacity buffer
(counterpart of ``rise_sdf_tpu/ops/march.py``).

1. a static ``[R, S]`` grid of candidate intervals per ray (one
   stratified offset per ray; uniform steps, or with ``cone_angle``
   above 0 nerfacc's steps that grow with the distance), optionally cut
   to a per-ray visibility range ``[t_band_lo, t_cut)`` from a coarse
   probe (``compute_visibility_cut``), or replaced on banded rays by exactly
   ``band_k`` samples spanning the band,
2. candidates masked by the AABB range and a packed-bit occupancy grid,
3. live samples compacted ray-major into ``capacity`` slots by a cumsum
   and a scatter into a ``capacity + 1`` buffer whose last slot takes
   every dropped candidate; rays whose samples overflow are flagged
   excluded.  Dead slots carry ``ray_indices == n_rays``.

``march_rays_dense`` is the uncompacted ``[R, S]`` variant for the
secondary occlusion rays.  Everything keeps a static shape, so nothing
waits on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def ray_aabb_intersect(rays_o, rays_d, aabb_min, aabb_max):
    """Slab test. Returns (t_near, t_far); miss encoded as t_near > t_far;
    t_near clamped >= 0."""
    safe_d = torch.where(rays_d.abs() > 1e-10, rays_d,
                         torch.where(rays_d >= 0, 1e-10, -1e-10))
    inv_d = 1.0 / safe_d
    t0 = (aabb_min - rays_o) * inv_d
    t1 = (aabb_max - rays_o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return torch.clamp(t_near, min=0.0), t_far


class RaySamples(NamedTuple):
    """Compacted ray-major sample buffer (all arrays length ``capacity``)."""

    t_starts: torch.Tensor      # [C]
    t_ends: torch.Tensor        # [C]
    ray_indices: torch.Tensor   # [C] int64; == n_rays for empty slots
    valid: torch.Tensor         # [C] bool
    ray_start: torch.Tensor     # [R] buffer offset of each ray's samples
    ray_count: torch.Tensor     # [R] live samples per ray (pre-drop)
    ray_included: torch.Tensor  # [R] bool: all live samples fit the buffer
    num_live: torch.Tensor      # [] total live samples before dropping


def pack_occupancy_bits(binary: torch.Tensor) -> torch.Tensor:
    """[M] bool -> [M/32] words (int64 holding the uint32 bit pattern;
    M must be a multiple of 32)."""
    bits = binary.reshape(-1, 32).long()
    shifts = torch.arange(32, device=binary.device, dtype=torch.int64)
    return (bits << shifts).sum(dim=1)


def occupancy_lookup(binary, positions, aabb_min, aabb_max, resolution):
    """Binary occupancy of world positions against a [res^3] bitfield."""
    words = pack_occupancy_bits(binary)
    u = (positions - aabb_min) / (aabb_max - aabb_min)
    idx = torch.floor(u * resolution).long()
    inside = ((idx >= 0) & (idx < resolution)).all(dim=-1)
    idx = idx.clamp(0, resolution - 1)
    flat = (idx[..., 0] * resolution + idx[..., 1]) * resolution + idx[..., 2]
    bit = (words[flat >> 5] >> (flat & 31)) & 1
    return inside & (bit == 1)


def _offsets(n_rays, generator, device, default=0.5):
    """[R, 1] stratification offsets (``default`` when unstratified)."""
    if generator is not None:
        return torch.rand((n_rays, 1), generator=generator, device=device)
    return torch.full((n_rays, 1), default, device=device)


def candidate_intervals(t_near, t_far, step_size, num_samples,
                        generator: Optional[torch.Generator] = None,
                        cone_angle: float = 0.0, dt_max: float = 1e10):
    """[R, S] candidate intervals, stratified by one offset per ray
    (mid-interval when ``generator`` is None).  Uniform steps of
    ``step_size``, or with ``cone_angle > 0`` nerfacc's recurrence: the
    k-th step is ``dt_k = clamp(t_k * cone_angle, step_size, dt_max)``
    from ``t_0 = t_near`` (uniform near the camera, geometric beyond
    ``step_size / cone_angle``), one float32 step at a time as the JAX
    scan takes it."""
    n_rays = t_near.shape[0]
    u = _offsets(n_rays, generator, t_near.device)
    if cone_angle and cone_angle > 0.0:
        t, t_lo, dts = t_near, [], []
        for _ in range(num_samples):
            dt = torch.clamp(t * cone_angle, step_size, dt_max)
            t_lo.append(t)
            dts.append(dt)
            t = t + dt
        t_lo, dts = torch.stack(t_lo, 1), torch.stack(dts, 1)  # [R, S]
        t0 = t_lo + u * dts
        t_starts = t0 - 0.5 * dts
        t_ends = t0 + 0.5 * dts
    else:
        steps = torch.arange(num_samples, dtype=torch.float32,
                             device=t_near.device)[None, :]
        t0 = t_near[:, None] + (steps + u) * step_size
        t_starts = t0 - 0.5 * step_size
        t_ends = t0 + 0.5 * step_size
    in_range = (t0 >= t_near[:, None]) & (t0 < t_far[:, None])
    return t_starts, t_ends, in_range


def march_rays(rays_o, rays_d, *, aabb_min, aabb_max, step_size, num_samples,
               capacity, grid_binary=None, grid_resolution=128,
               generator: Optional[torch.Generator] = None,
               t_cut: Optional[torch.Tensor] = None,
               t_band_lo: Optional[torch.Tensor] = None,
               band_k: Optional[int] = None,
               cone_angle: float = 0.0) -> RaySamples:
    """Occupancy-pruned marching, compacted to a fixed-size buffer.

    ``t_cut`` [R] drops candidates at ``t_mid >= t_cut`` (occluded),
    ``t_band_lo`` [R] those before it.  With ``band_k`` (and both
    bounds) each ray whose band is finite gets exactly ``band_k``
    uniform samples spanning ``[max(t_band_lo, t_near), min(t_cut,
    t_far))`` (the AABB entry and exit)
    instead of the masked fine-step candidates, so banded rays can
    never overflow a buffer of ``n_rays * band_k``.  ``cone_angle`` goes
    to ``candidate_intervals``."""
    n_rays = rays_o.shape[0]
    dev = rays_o.device
    t_near, t_far = ray_aabb_intersect(rays_o, rays_d, aabb_min, aabb_max)
    t_starts, t_ends, live = candidate_intervals(
        t_near, t_far, step_size, num_samples, generator, cone_angle)
    if band_k is not None and t_cut is not None and t_band_lo is not None:
        k = min(int(band_k), num_samples)
        big = 1e9
        lo = torch.maximum(t_band_lo, t_near)
        hi = torch.minimum(t_cut, t_far)
        finite = (t_cut < big) & (t_band_lo > -big) & (hi > lo)
        step_b = ((hi - lo) / k)[:, None]                     # [R, 1]
        ub = _offsets(n_rays, generator, dev)
        steps = torch.arange(num_samples, dtype=torch.float32,
                             device=dev)[None, :]
        t0b = lo[:, None] + (steps + ub) * step_b
        f = finite[:, None]
        t_starts = torch.where(f, t0b - 0.5 * step_b, t_starts)
        t_ends = torch.where(f, t0b + 0.5 * step_b, t_ends)
        live = torch.where(f, steps < k, live)

    t_mid = 0.5 * (t_starts + t_ends)
    if t_cut is not None:
        live = live & (t_mid < t_cut[:, None])
    if t_band_lo is not None:
        live = live & (t_mid >= t_band_lo[:, None])
    if grid_binary is not None:
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t_mid[..., None]
        live = live & occupancy_lookup(grid_binary, pos, aabb_min, aabb_max,
                                       grid_resolution)

    # ---- compaction (ray-major flatten preserves per-ray ordering) ---- #
    flat_live = live.reshape(-1)
    pos_in_buf = torch.cumsum(flat_live, 0) - 1
    num_live = pos_in_buf[-1] + 1 if flat_live.numel() else \
        torch.zeros((), dtype=torch.int64, device=dev)
    buf_valid = torch.arange(capacity, device=dev) \
        < torch.clamp(num_live, max=capacity)
    # each slot gathers its sample (the (j+1)-th live one): torch's
    # deterministic scatter would write the dead samples' shared slot one
    # by one (0.37 s a call on an H100 at 4M samples)
    src_of = torch.clamp(torch.searchsorted(
        pos_in_buf + 1, torch.arange(1, capacity + 1, device=dev)),
        max=max(flat_live.numel() - 1, 0))

    def compact(src, fill):
        return torch.where(buf_valid, src.index_select(0, src_of),
                           torch.full((), fill, dtype=src.dtype, device=dev))

    flat_ray = torch.arange(n_rays, device=dev).repeat_interleave(num_samples)
    buf_ts = compact(t_starts.reshape(-1), 0.0)
    buf_te = compact(t_ends.reshape(-1), 0.0)
    buf_ray = compact(flat_ray, n_rays)

    ray_count = live.sum(dim=1)
    ray_end = torch.cumsum(ray_count, 0)
    ray_start = ray_end - ray_count
    return RaySamples(
        t_starts=buf_ts, t_ends=buf_te, ray_indices=buf_ray, valid=buf_valid,
        ray_start=torch.clamp(ray_start, max=capacity), ray_count=ray_count,
        ray_included=ray_end <= capacity, num_live=num_live,
    )


def compute_visibility_cut(rays_o, rays_d, *, sdf_fn, inv_s, aabb_min,
                           aabb_max, step_size, num_samples, capacity,
                           grid_binary=None, grid_resolution=128,
                           stride: int = 4, cos_anneal_ratio=1.0,
                           early_stop_eps: float = 1e-4,
                           margin_intervals: float = 1.0,
                           band: bool = False, deterministic: bool = False):
    """Per-ray transmittance cut from a coarse SDF probe.

    Marches a coarse grid (``stride`` fine steps per probe) into a
    ``capacity`` buffer, evaluates ``sdf_fn`` there without gradients,
    takes the ray-direction cosine from the SDF difference of the
    neighbouring probes of the same ray (one-sided at a ray's ends;
    -1, head-on, for a lone probe) and the NeuS alpha of each probe.
    Returns ``t_cut`` [R] (``transmittance_cut``), or with ``band`` the
    ``(t_lo, t_cut)`` band (``transmittance_band``); the margin is
    ``margin_intervals`` coarse steps; ``deterministic`` goes to the
    scan (``volrend``)."""
    from . import volrend
    from ..models.neus import neus_alpha

    n_rays = rays_o.shape[0]
    coarse_step = step_size * stride
    n_coarse = max(num_samples // stride, 1)
    rs = march_rays(
        rays_o, rays_d, aabb_min=aabb_min, aabb_max=aabb_max,
        step_size=coarse_step, num_samples=n_coarse, capacity=capacity,
        grid_binary=grid_binary, grid_resolution=grid_resolution,
        generator=None)
    t_mid = 0.5 * (rs.t_starts + rs.t_ends)
    ridx = torch.clamp(rs.ray_indices, 0, n_rays - 1)
    pos = rays_o[ridx] + rays_d[ridx] * t_mid[:, None]
    with torch.no_grad():
        sdf = sdf_fn(pos)

    c = capacity
    pos_idx = torch.arange(c, device=rays_o.device)
    ri = rs.ray_indices
    same_p = (torch.roll(ri, 1) == ri) & torch.roll(rs.valid, 1) \
        & (pos_idx > 0)
    same_n = (torch.roll(ri, -1) == ri) & torch.roll(rs.valid, -1) \
        & (pos_idx < c - 1)
    s_lo = torch.where(same_p, torch.roll(sdf, 1), sdf)
    t_lo = torch.where(same_p, torch.roll(t_mid, 1), t_mid)
    s_hi = torch.where(same_n, torch.roll(sdf, -1), sdf)
    t_hi = torch.where(same_n, torch.roll(t_mid, -1), t_mid)
    denom = t_hi - t_lo
    cos = torch.where(denom > 1e-8,
                      (s_hi - s_lo) / torch.clamp(denom, min=1e-8), -1.0)
    cos = torch.clamp(cos, -1.0, 1.0)

    alpha = neus_alpha(sdf, inv_s, cos, rs.t_ends - rs.t_starts,
                       cos_anneal_ratio)
    fn = volrend.transmittance_band if band else volrend.transmittance_cut
    return fn(alpha, rs.t_starts, rs.ray_start, rs.ray_indices, rs.valid,
              n_rays, early_stop_eps=early_stop_eps,
              margin=margin_intervals * coarse_step,
              deterministic=deterministic)


def march_rays_dense(rays_o, rays_d, *, near_plane, far_plane, num_samples,
                     aabb_min, aabb_max, grid_binary=None, grid_resolution=128,
                     generator: Optional[torch.Generator] = None):
    """Uncompacted masked marching in ``[near, far]`` (secondary rays):
    samples at ``near + (i + u) * step``, ``step = (far - near) /
    (S - 1)``, ``u = 0`` unless ``generator`` stratifies.  Returns
    ``(t_starts, t_ends, live)``, each ``[R, S]``."""
    n_rays = rays_o.shape[0]
    step_size = (far_plane - near_plane) / (num_samples - 1)
    t_near, t_far = ray_aabb_intersect(rays_o, rays_d, aabb_min, aabb_max)
    t_near = torch.clamp(t_near, min=near_plane)
    t_far = torch.clamp(t_far, max=far_plane)
    u = _offsets(n_rays, generator, rays_o.device, default=0.0)
    steps = torch.arange(num_samples, dtype=torch.float32,
                         device=rays_o.device)[None, :]
    t0 = near_plane + (steps + u) * step_size
    t_starts = t0 - 0.5 * step_size
    t_ends = t0 + 0.5 * step_size
    live = (t0 >= t_near[:, None]) & (t0 < t_far[:, None])
    if grid_binary is not None:
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t0[..., None]
        live = live & occupancy_lookup(grid_binary, pos, aabb_min, aabb_max,
                                       grid_resolution)
    return t_starts, t_ends, live
