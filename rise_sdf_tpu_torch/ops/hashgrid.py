"""Multiresolution hash-grid encoding (counterpart of
``rise_sdf_tpu/ops/hashgrid.py``, the plain-encode path).

Level resolutions follow instant-ngp, ``res_l = floor(base * b^l)``;
levels whose dense grid fits the table index densely, the rest through
the instant-ngp spatial hash.  The tables are one ``[L, T, F]``
parameter.  One encode builds a single ``[N, L_open, 8]`` row-index
tensor into the flattened ``[L*T, F]`` table (level l offset by
``l*T``) and gathers it through ``TableGradLookup``, so the backward is
one K1 launch for all levels and never materialises a per-level slice
gradient.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from .scatter import table_grad_lookup

# instant-ngp spatial hash primes
_PRIMES = (1, 2654435761, 805459861)


class HashGridEncoding(nn.Module):
    def __init__(self, in_channels: int, config: Dict[str, Any]):
        super().__init__()
        assert in_channels == 3, "hash grid encode implemented for 3D inputs"
        self.n_input_dims = 3
        self.n_levels = int(config["n_levels"])
        self.n_features_per_level = int(config["n_features_per_level"])
        self.log2_hashmap_size = int(config["log2_hashmap_size"])
        self.base_resolution = int(config["base_resolution"])
        self.per_level_scale = float(config["per_level_scale"])
        self.table_size = 2 ** self.log2_hashmap_size
        self.n_output_dims = self.n_levels * self.n_features_per_level

        # progressive band opening (ProgressiveBandHashGrid); for plain
        # HashGrid all levels are always open
        self.progressive = config.get("otype", "HashGrid") \
            == "ProgressiveBandHashGrid"
        self.start_level = int(config.get("start_level", self.n_levels))
        self.start_step = int(config.get("start_step", 0))
        self.update_steps = int(config.get("update_steps", 1))

        self.resolutions = [
            int(math.floor(self.base_resolution * self.per_level_scale ** l))
            for l in range(self.n_levels)]
        # dense indexing when the full grid fits into the hash table; the
        # resolutions grow with l, so the dense levels are a prefix
        self.dense = [(r + 1) ** 3 <= self.table_size
                      for r in self.resolutions]
        self.n_dense = sum(self.dense)
        self.table = nn.Parameter(torch.empty(
            self.n_levels, self.table_size, self.n_features_per_level))
        # per-level constants live beside the table, so an encode on the
        # card copies nothing from the host (such a copy waits for the
        # stream)
        self.register_buffer("level_res", torch.tensor(
            self.resolutions, dtype=torch.float32), persistent=False)
        self.register_buffer("dense_stride", torch.tensor(
            [r + 1 for r in self.resolutions], dtype=torch.int64),
            persistent=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.table.copy_(torch.rand(self.table.shape, generator=generator)
                         * 2e-4 - 1e-4)

    # ------------------------------------------------------------------ #
    def current_level(self, step) -> int:
        """Number of open levels at ``step``."""
        if not self.progressive:
            return self.n_levels
        lvl = self.start_level \
            + max(int(step) - self.start_step, 0) // self.update_steps
        return min(lvl, self.n_levels)

    def level_mask(self, step, device=None) -> torch.Tensor:
        """[L] float mask of open levels."""
        cur = self.current_level(step)
        return (torch.arange(self.n_levels, device=device) < cur).float()

    @staticmethod
    def _level_range(levels, n_levels):
        """Normalize the ``levels`` spec (count or (lo, hi)) to a range."""
        if levels is None:
            return 0, n_levels
        if isinstance(levels, tuple):
            lo, hi = levels
            return int(lo), int(min(hi, n_levels))
        return 0, int(min(levels, n_levels))

    # ------------------------------------------------------------------ #
    def _flat_index(self, c: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Per-axis integer corners ``c`` [N, hi-lo, 2, 3] (int64) of
        levels [lo, hi), all dense or all hashed -> [N, hi-lo, 8] rows of
        the level's table (corner order cx-major, as the JAX encode).

        The hash is taken in int64 and masked with ``T-1``: the low 19
        bits equal those of the JAX uint32 wraparound."""
        cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]          # [N, Lr, 2]
        if self.dense[lo]:
            s = self.dense_stride[lo:hi].view(-1, 1, 1, 1)
            flat = (cx[..., :, None, None]
                    + s * (cy[..., None, :, None]
                           + s * cz[..., None, None, :]))
        else:
            flat = ((cx * _PRIMES[0])[..., :, None, None]
                    ^ (cy * _PRIMES[1])[..., None, :, None]
                    ^ (cz * _PRIMES[2])[..., None, None, :]) \
                & (self.table_size - 1)
        return flat.reshape(*flat.shape[:2], 8)

    @staticmethod
    def _corner_weights(w: torch.Tensor) -> torch.Tensor:
        """Fractions [N, L, 3] -> trilinear weights [N, L, 8] (cx-major)."""
        wx = torch.stack([1.0 - w[..., 0], w[..., 0]], -1)
        wy = torch.stack([1.0 - w[..., 1], w[..., 1]], -1)
        wz = torch.stack([1.0 - w[..., 2], w[..., 2]], -1)
        cw = (wx[..., :, None, None] * wy[..., None, :, None]
              * wz[..., None, None, :])
        return cw.reshape(*w.shape[:2], 8)

    def forward(self, x: torch.Tensor, step=None, levels=None) -> torch.Tensor:
        """Encode ``x`` [N, 3] in [0,1]^3 -> [N, L*F] features
        (level-major).  ``levels`` (count or (lo, hi)) skips the gathers
        of levels outside the range; their feature slots are zeros."""
        lo, hi = self._level_range(levels, self.n_levels)
        n, L, F, T = x.shape[0], self.n_levels, self.n_features_per_level, \
            self.table_size
        if hi <= lo:
            return x.new_zeros((n, L * F))
        res = self.level_res[lo:hi].to(x.dtype)
        pos = x[:, None, :] * res[None, :, None]              # [N, Lo, 3]
        # floor has zero gradient: x-gradients flow through the weights
        i0 = torch.minimum(torch.floor(pos.detach()).clamp_(min=0.0),
                           (res - 1.0)[None, :, None])
        w = pos - i0
        i0 = i0.long()
        corners = torch.stack([i0, i0 + 1], dim=2)            # [N, Lo, 2, 3]
        # dense levels are a prefix of the range
        split = min(max(self.n_dense, lo), hi)
        parts = [self._flat_index(corners[:, a - lo:b - lo], a, b)
                 for a, b in ((lo, split), (split, hi)) if b > a]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
        offs = torch.arange(lo, hi, device=x.device, dtype=torch.int64) * T
        rows = (flat + offs[None, :, None]).to(torch.int32)   # [N, Lo, 8]
        vals = table_grad_lookup(self.table.view(L * T, F), rows)
        feats = (self._corner_weights(w)[..., None] * vals).sum(2)
        if self.progressive:  # all-open grids skip the exact x1.0
            mask = self.level_mask(step if step is not None else 10 ** 9,
                                   feats.device)
            feats = feats * mask[lo:hi].to(feats.dtype)[None, :, None]
        if hi - lo < L:
            feats = torch.cat([feats.new_zeros((n, lo, F)), feats,
                               feats.new_zeros((n, L - hi, F))], 1)
        return feats.reshape(n, L * F)
