"""Batched fixed-iteration sphere tracing on a learned SDF (counterpart
of ``rise_sdf_tpu/ops/sphere_trace.py``).

A direct root find on the SDF replaces the volumetric eval's samples
once the surface is sharp: every iteration probes the SDF once for
every ray of the chunk (one hash encode and MLP of ``[R]`` points), with
no sample buffer, compaction or scan.  The iteration counts are fixed
and finished rays are masked, not removed, so the shapes do not depend
on the data and nothing waits on the device; a false-position
refinement then brackets the crossing in ``refine_iters`` more probes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .march import ray_aabb_intersect


class TraceResult(NamedTuple):
    t_hit: torch.Tensor      # [R] parameter of the surface crossing
    hit: torch.Tensor        # [R] bool: converged onto a crossing
    converged: torch.Tensor  # [R] bool: hit, or left the AABB; the rest
    #                          ran out of iterations inside the volume
    sdf_last: torch.Tensor   # [R] SDF at t_hit
    sdf_min: torch.Tensor    # [R] least SDF over every probe of the ray


@torch.no_grad()
def sphere_trace(rays_o: torch.Tensor, rays_d: torch.Tensor, *,
                 sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                 aabb_min, aabb_max, n_iters: int = 48,
                 refine_iters: int = 4, hit_eps: float = 1e-3,
                 relax: float = 0.9) -> TraceResult:
    """March ``t += relax * sdf`` from the AABB entry until the SDF drops
    below ``hit_eps`` (arrival) or below 0 (overshoot, bracketed and
    refined by false position); ``rays_d`` unit.  Every ray is probed in
    every iteration, finished ones included, and each update is a
    ``torch.where``, as the JAX scan does: a lane that ``where`` discards
    may hold inf or NaN (``s = inf`` outside the box)."""
    t_near, t_far = ray_aabb_intersect(rays_o, rays_d, aabb_min, aabb_max)
    inside = t_near <= t_far
    t0 = torch.where(inside, t_near, t_far)

    def probe(t):
        return sdf_fn(rays_o + rays_d * t[:, None])

    s0 = torch.where(inside, probe(t0), float("inf"))
    t, s, t_lo, s_lo, s_min, done = t0, s0, t0, s0, s0, ~inside
    for _ in range(n_iters):
        arrived = s < hit_eps          # overshoot (s < 0) included
        done_now = done | arrived | (t > t_far)
        # the last strictly positive probe is the bracket's floor
        adv = ~done_now
        t_lo = torch.where(adv, t, t_lo)
        s_lo = torch.where(adv, s, s_lo)
        t_new = torch.where(adv, t + relax * s, t)
        s_new = torch.where(done_now, s, probe(t_new))
        t, s = t_new, s_new
        s_min = torch.minimum(s_min, s_new)
        done = done_now | done

    # false position on bracketed crossings (s_lo > 0 > s); arrivals that
    # stopped short (0 <= s < hit_eps) close the gap with un-relaxed
    # t += s steps, one shared probe per iteration for both
    arrived_short = (s >= 0.0) & (s < hit_eps) & inside
    bracketed = (s < 0.0) & (s_lo > 0.0)
    t_hi, s_hi = t, s
    for _ in range(refine_iters):
        denom = s_lo - s_hi
        t_fp = torch.where(denom.abs() > 1e-12,
                           t_lo + s_lo * (t_hi - t_lo) / denom,
                           0.5 * (t_lo + t_hi))
        t_cand = torch.where(bracketed, t_fp,
                             torch.where(arrived_short, t + s, t))
        active = bracketed | arrived_short
        s_cand = torch.where(active, probe(t_cand), s)
        neg = s_cand < 0.0
        lower, upper = bracketed & ~neg, bracketed & neg
        t_hi = torch.where(upper, t_cand, t_hi)
        s_hi = torch.where(upper, s_cand, s_hi)
        t_lo = torch.where(lower, t_cand, t_lo)
        s_lo = torch.where(lower, s_cand, s_lo)
        # a short-arrival step that overshoots becomes a bracket
        crossed = arrived_short & neg
        t_lo = torch.where(crossed, t, t_lo)
        s_lo = torch.where(crossed, s, s_lo)
        t_hi = torch.where(crossed, t_cand, t_hi)
        s_hi = torch.where(crossed, s_cand, s_hi)
        bracketed = bracketed | crossed
        arrived_short = arrived_short & ~neg
        t = torch.where(active, t_cand, t)
        s = torch.where(active, s_cand, s)

    hit = inside & (s < hit_eps) & (t <= t_far)
    converged = ~inside | hit | (t > t_far)
    return TraceResult(t_hit=t, hit=hit, converged=converged, sdf_last=s,
                       sdf_min=torch.minimum(s_min, s))
