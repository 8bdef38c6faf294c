"""Importance resampling along rays by CDF inversion (counterpart of
``rise_sdf_tpu/ops/resample.py``, nerfacc's ``ray_resampling``).

Padded layout: every ray of ``[R, S]`` intervals resamples ``n_new``
intervals from its weights.  Nothing in either package calls it yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def ray_resampling(t_starts, t_ends, weights, live, n_new: int,
                   generator: Optional[torch.Generator] = None,
                   padding: float = 0.01, u: Optional[torch.Tensor] = None):
    """(new_t_starts, new_t_ends) [R, n_new] drawn in proportion to
    ``weights`` (negative and dead entries count 0) plus a uniform floor
    ``padding / S``.  The ``n_new`` stratified positions are
    ``(k + u) / n_new`` with ``u`` [R, n_new] given, drawn from
    ``generator``, or 0.5 when neither is given.  The drawn points
    become contiguous intervals through their midpoints."""
    r, s = weights.shape
    w = torch.where(live, torch.clamp(weights, min=0.0), 0.0) + padding / s
    cdf = torch.cumsum(w, dim=1)
    cdf = cdf / cdf[:, -1:]
    cdf = torch.cat([cdf.new_zeros((r, 1)), cdf], dim=1)  # [R, S + 1]
    k = torch.arange(n_new, device=weights.device,
                     dtype=weights.dtype)[None, :]
    if u is None and generator is not None:
        u = torch.rand((r, n_new), generator=generator,
                       device=weights.device, dtype=weights.dtype)
    u = (k + u) / n_new if u is not None else \
        ((k + 0.5) / n_new).expand(r, n_new)
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True) - 1,
                      0, s - 1)
    c0 = torch.gather(cdf, 1, idx)
    c1 = torch.gather(cdf, 1, idx + 1)
    frac = (u - c0) / torch.clamp(c1 - c0, min=1e-12)
    ts = torch.gather(t_starts, 1, idx)
    te = torch.gather(t_ends, 1, idx)
    t = ts + frac * (te - ts)
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    return (torch.cat([t[:, :1], mids], dim=1),
            torch.cat([mids, t[:, -1:]], dim=1))
