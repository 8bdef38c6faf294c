"""Occupancy grid state (counterpart of ``rise_sdf_tpu/ops/grid.py``).

The training sweep, over a rotating quarter of the cells, lives in
``systems/base.py`` (``BaseSystem.update_occupancy``); ``cell_positions``
and ``update_grid`` are the whole-grid step.  The state is the pair
``(occs, binary)``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def init_grid(resolution: int = 128, device=None):
    """-> (occs [res^3] float32 EMA occupancy, binary [res^3] bool), fully
    occupied until the first update."""
    n = resolution ** 3
    return (torch.zeros(n, dtype=torch.float32, device=device),
            torch.ones(n, dtype=torch.bool, device=device))


def cell_positions(resolution: int, aabb_min, aabb_max,
                   jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """World positions [res^3, 3] of every cell (x-major), at the centre
    or at ``jitter`` [res^3, 3] (uniform draws in [0, 1)) inside each
    cell."""
    r = resolution
    idx = torch.arange(r ** 3, device=torch.as_tensor(aabb_min).device)
    ijk = torch.stack([idx // (r * r), (idx // r) % r, idx % r],
                      -1).float()
    unit = (ijk + (0.5 if jitter is None else jitter)) / r
    return aabb_min + unit * (aabb_max - aabb_min)


def update_grid(grid: Tuple[torch.Tensor, torch.Tensor],
                occ_new: torch.Tensor, occ_thre: float = 0.01,
                ema_decay: float = 0.95):
    """One whole-grid update of ``grid`` = (occs, binary) by the fresh
    occupancies ``occ_new`` [res^3]: the EMA ``max(occs * decay, new)``
    and the binary grid above ``min(mean, occ_thre)``."""
    occs = torch.maximum(grid[0] * ema_decay, occ_new)
    return occs, occs > torch.clamp(occs.mean(), max=occ_thre)
