"""Multiresolution hash-grid encoding (counterpart of
``rise_sdf_tpu/ops/hashgrid.py``: the plain encode, ``encode_with_grad``
and ``encode_axis_probes``).

Level resolutions follow instant-ngp, ``res_l = floor(base * b^l)``;
levels whose dense grid fits the table index densely, the rest through
the instant-ngp spatial hash.  The tables are one ``[L, T, F]``
parameter.  Each encode builds a single ``[N, L_open, K]`` row-index
tensor into the flattened ``[L*T, F]`` table (level l offset by
``l*T``; K = 8 cell corners, or the 32-point probe neighbourhood) and
gathers it through ``TableGradLookup``, so the backward is one K1
launch for all levels and never materialises a per-level slice
gradient.

Every encode takes ``grad_impl``, as the JAX encoding's ``apply``:
``'plain'`` (the default, K1) or ``'sorted'``, the deterministic table
gradient (K2, ``ops/scatter_sorted.py``; the counterpart of
``_encode_sorted_vjp``).  Under ``torch.use_deterministic_algorithms
(True)`` every encode takes ``'sorted'``.  The position gradient is the
same either way, and unlike JAX's custom VJP the sorted one can be
differentiated again: it is first-order in the table only.

Row sharding (``shard_table``, JAX's ``model`` mesh axis and
``_lookup_masked``): shard ``m`` of ``tp`` holds rows ``[m T / tp, (m +
1) T / tp)`` of every level as its ``[L, T / tp, F]`` parameter.  The
hash and the dense-level test still take the global ``T``; a row that
another shard owns becomes an absent row (index -1), which G1 reads as
zeros and K1 and K2 drop, so the table gradient stays in the shard.
Each encode's outputs are summed over the shard's model group by one
all-reduce (``_reduce``), whose backward hands the replicated cotangent
to this shard's rows unchanged, as JAX's ``v + stop_gradient(psum(v) -
v)`` does; the positions enter through an identity whose backward sums
their cotangent over the group (``_enter``), since every shard holds a
part of d features / d x.  The pair (Megatron's reduce-from and
copy-to regions) is each other's backward, so it is right at every
order: the analytic SDF gradient (``VolumeSDF.analytic_grad``: eval
normals, the secondary pass' alpha) is the whole one, and its own
gradient reaches the tables and the MLP whole.  A sharded encode takes
the plain table gradient for ``grad_impl='sorted'``, as JAX's ``apply``
does (the deterministic switch still takes K2).

Where no graph through the encode is kept (``forward(...,
eval_encode=True)``: ``VolumeSDF`` entered with grad disabled), the
features on the card come from ``EvalEncode``, the pair E1
(``ops/hashgrid_eval.py``): one launch for the features and one for
their position gradient, with no table gradient.  On the CPU the chain
above is their plain counterpart and runs as it is.  Every encode with
grad enabled keeps the chain, G1 and K1.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.autograd.function import once_differentiable

from .. import trace
from . import hashgrid_eval
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
        self.register_buffer("off32", _off32(), persistent=False)
        # (tp, shard index, model group) once row-sharded; a full table
        # that stands in for the shard (``unsharded``)
        self.shard = None
        self._full = None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The full table's draw; a shard keeps its own rows of it."""
        full = torch.rand((self.n_levels, self.table_size,
                           self.n_features_per_level),
                          generator=generator) * 2e-4 - 1e-4
        if self.shard is not None:
            tp, index, _ = self.shard
            rows = self.table_size // tp
            full = full[:, index * rows:(index + 1) * rows]
        self.table.copy_(full)

    @torch.no_grad()
    def shard_table(self, tp: int, index: int, group) -> None:
        """Keep rows ``[index T / tp, (index + 1) T / tp)`` of every level
        as the parameter, and sum every encode over ``group`` (the model
        group of ``tp`` ranks; a lookup without one raises)."""
        if self.shard is not None:
            raise RuntimeError("the hash table is sharded already")
        if tp < 2 or self.table_size % tp or not 0 <= index < tp:
            raise ValueError(f"a table of {self.table_size} rows does not "
                             f"split into shard {index} of {tp}")
        rows = self.table_size // tp
        self.table = nn.Parameter(
            self.table[:, index * rows:(index + 1) * rows].clone(),
            requires_grad=self.table.requires_grad)
        self.shard = (tp, index, group)

    @contextmanager
    def unsharded(self, full: torch.Tensor):
        """Encodes inside read the whole ``[L, T, F]`` table ``full`` with
        no collective (a sharded table gathered for one rank's use)."""
        if tuple(full.shape) != (self.n_levels, self.table_size,
                                 self.n_features_per_level):
            raise ValueError(f"a full table is {self.n_levels} x "
                             f"{self.table_size} x "
                             f"{self.n_features_per_level}, not "
                             f"{tuple(full.shape)}")
        self._full = full
        try:
            yield
        finally:
            self._full = None

    def _sharded(self) -> bool:
        return self.shard is not None and self._full is None

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
    def _cell(self, x: torch.Tensor, lo: int, hi: int):
        """Cell corner ``i0`` [N, Lo, 3] (int64, in [0, res - 1]) and the
        fractions ``w`` [N, Lo, 3] of ``x`` [N, 3] at levels [lo, hi).
        floor has zero gradient: x-gradients flow through ``w``."""
        res = self.level_res[lo:hi].to(x.dtype)
        pos = x[:, None, :] * res[None, :, None]
        i0 = torch.minimum(torch.floor(pos.detach()).clamp_(min=0.0),
                           (res - 1.0)[None, :, None])
        return i0.long(), pos - i0

    def _grid_rows(self, cx, cy, cz, lo: int, hi: int) -> torch.Tensor:
        """Integer grid points (per-axis int64 tensors that broadcast,
        level along dim 1) of levels [lo, hi), all dense or all hashed ->
        rows of the level's table.  The hash is taken in int64 and masked
        with ``T-1``: the low 19 bits equal those of the JAX uint32
        wraparound."""
        if self.dense[lo]:
            s = self.dense_stride[lo:hi].view(-1, *[1] * (cx.dim() - 2))
            return cx + s * (cy + s * cz)
        return ((cx * _PRIMES[0]) ^ (cy * _PRIMES[1]) ^ (cz * _PRIMES[2])) \
            & (self.table_size - 1)

    def _rows_by_band(self, fn, lo: int, hi: int) -> torch.Tensor:
        """``fn(a, b)`` -> [N, b - a, K] rows over the dense and the
        hashed part of [lo, hi) (the dense levels are a prefix), joined
        along the level axis."""
        split = min(max(self.n_dense, lo), hi)
        parts = [fn(a, b) for a, b in ((lo, split), (split, hi)) if b > a]
        return parts[0] if len(parts) == 1 else torch.cat(parts, 1)

    def _corner_rows(self, i0: torch.Tensor, lo: int, hi: int):
        """The 8 cell corners of ``i0`` [N, Lo, 3] -> [N, Lo, 8] rows
        (cx-major, as the JAX encode)."""
        def rows(a, b):
            c = i0[:, a - lo:b - lo]
            cx, cy, cz = (torch.stack([c[..., k], c[..., k] + 1], -1)
                          for k in range(3))
            flat = self._grid_rows(cx[..., :, None, None],
                                   cy[..., None, :, None],
                                   cz[..., None, None, :], a, b)
            return flat.flatten(-3)
        return self._rows_by_band(rows, lo, hi)

    def _lookup(self, flat: torch.Tensor, lo: int,
                grad_impl: str = "plain") -> torch.Tensor:
        """[N, Lo, K] rows of levels lo, lo + 1, ... -> [N, Lo, K, F]
        values: one gather from the flattened ``[L*T, F]`` table (G1 on
        the card), whose table gradient is one K1 launch (K2 with
        ``grad_impl='sorted'``).  A shard's table is ``[L*T/tp, F]``:
        global row ``flat`` of level l is its row ``l T/tp + flat - m
        T/tp``, or absent (-1) outside the shard; the caller sums the
        values' contributions over the model group (``_reduce``)."""
        L, F = self.n_levels, self.n_features_per_level
        table = self.table if self._full is None else self._full
        rows = table.shape[1]
        offs = torch.arange(lo, lo + flat.shape[1], device=flat.device,
                            dtype=torch.int64)[None, :, None] * rows
        if self._sharded():
            tp, index, group = self.shard
            if group is None or not dist.is_initialized():
                raise RuntimeError(
                    f"shard {index} of {tp} of a row-sharded hash table "
                    "looked up without its model group: its features "
                    "would be one shard's part")
            local = flat - index * rows
            flat = torch.where((local >= 0) & (local < rows), local + offs,
                               -1)
            grad_impl = "plain"  # as JAX's apply: sorted takes the plain
        else:
            flat = flat + offs
        return table_grad_lookup(table.view(L * rows, F),
                                 flat.to(torch.int32), grad_impl)

    def _reduce(self, *outs: torch.Tensor):
        """The encode's outputs summed over the model group of a sharded
        table (each row lives in one shard, so the sum is the unsharded
        encode), in one all-reduce (``ReduceFrom``): the value is the
        all-reduce bit for bit, the same on every rank of the group, so
        the ranks take the same branches downstream.  Unsharded:
        ``outs`` as they are."""
        if self._sharded():
            outs = ReduceFrom.apply(self.shard[2], *outs)
        return outs if len(outs) > 1 else outs[0]

    def _enter(self, *xs: torch.Tensor):
        """The encode's positions; sharded, through ``CopyTo``, so that
        their gradient sums every shard's part.  A position that takes
        no gradient passes as it is."""
        if not self._sharded():
            return xs if len(xs) > 1 else xs[0]
        xs = tuple(CopyTo.apply(self.shard[2], x)[0] if x.requires_grad
                   else x for x in xs)
        return xs if len(xs) > 1 else xs[0]

    def _level_out(self, feats: torch.Tensor, lo: int, hi: int, step):
        """[..., N, Lo, F] features of levels [lo, hi) -> [..., N, L*F]:
        the progressive mask applied, closed slots zero."""
        if self.progressive:  # all-open grids skip the exact x1.0
            mask = self.level_mask(step if step is not None else 10 ** 9,
                                   feats.device)
            feats = feats * mask[lo:hi].to(feats.dtype)[:, None]
        L, F = self.n_levels, self.n_features_per_level
        if hi - lo < L:
            pad = list(feats.shape)
            pad[-2] = L
            out = feats.new_zeros(pad)
            out[..., lo:hi, :] = feats
            feats = out
        return feats.flatten(-2)

    def forward(self, x: torch.Tensor, step=None, levels=None,
                grad_impl: str = "plain",
                eval_encode: bool = False) -> torch.Tensor:
        """Encode ``x`` [N, 3] in [0,1]^3 -> [N, L*F] features
        (level-major).  ``levels`` (count or (lo, hi)) skips the gathers
        of levels outside the range; their feature slots are zeros.
        ``grad_impl``: the table gradient, ``'plain'`` or ``'sorted'``.
        ``eval_encode``: the caller keeps no graph through the encode
        (``VolumeSDF`` entered with grad disabled), so the features come
        from ``EvalEncode``, with no table gradient and a position
        gradient that cannot be differentiated again.  E1 runs on the
        card and is written for float32 points and tables of 2 features
        a level (every shipped configuration); other encodes, CPU
        tensors (where the chain is E1's plain counterpart) and a
        row-sharded table take the chain all the same."""
        lo, hi = self._level_range(levels, self.n_levels)
        if hi <= lo:
            return x.new_zeros((x.shape[0], self.n_output_dims))
        table = self.table if self._full is None else self._full
        if (eval_encode and x.is_cuda and not self._sharded()
                and self.n_features_per_level == 2
                and x.dtype == table.dtype == torch.float32):
            trace.count("encode.eval_points", x.shape[0])
            return EvalEncode.apply(x, table.detach(),
                                    self.eval_levels(lo, hi, step))
        trace.count("encode.chain_points", x.shape[0])
        return self._chain(x, step, lo, hi, grad_impl)

    def eval_levels(self, lo: int, hi: int, step) -> hashgrid_eval.Levels:
        """The level constants of ``EvalEncode`` over [lo, hi) at
        ``step`` (the progressive mask as the chain's)."""
        cur = self.current_level(step if step is not None else 10 ** 9)
        return hashgrid_eval.Levels(
            res=[float(r) for r in self.resolutions],
            stride=[r + 1 for r in self.resolutions],
            mask=[1.0 if l < cur else 0.0 for l in range(self.n_levels)],
            lo=lo, hi=hi, n_dense=self.n_dense, table_size=self.table_size)

    def _chain(self, x, step, lo: int, hi: int, grad_impl: str = "plain"):
        """The encode of levels [lo, hi) as torch ops around G1, whose
        table gradient is K1 (or K2)."""
        i0, w = self._cell(self._enter(x), lo, hi)
        vals = self._lookup(self._corner_rows(i0, lo, hi), lo, grad_impl)
        feats = self._reduce((_outer8(*_axis_pairs(w))[..., None]
                              * vals).sum(2))
        return self._level_out(feats, lo, hi, step)

    def encode_with_grad(self, x: torch.Tensor, step=None, levels=None,
                         grad_impl: str = "plain"):
        """Features and their x-space Jacobian for levels in range
        (``encode_with_grad`` of the JAX encoding): ``(feats, (jx, jy,
        jz))``, each [N, L*F].  The columns reuse the features' gathered
        rows, so their table gradient rides the same K1 launch."""
        lo, hi = self._level_range(levels, self.n_levels)
        if hi <= lo:
            z = x.new_zeros((x.shape[0], self.n_output_dims))
            return z, (z, z, z)
        trace.count("encode.chain_points", x.shape[0])
        i0, w = self._cell(self._enter(x), lo, hi)
        vals = self._lookup(self._corner_rows(i0, lo, hi), lo, grad_impl)
        pairs = _axis_pairs(w)
        feats = (_outer8(*pairs)[..., None] * vals).sum(2)
        one = torch.ones_like(w[..., 0])
        d = torch.stack([-one, one], -1)  # d/dw of (1 - w, w)
        res = self.level_res[lo:hi].to(x.dtype)[None, :, None]
        jac = []
        for a in range(3):
            dp = list(pairs)
            dp[a] = d
            jac.append((_outer8(*dp)[..., None] * vals).sum(2) * res)
        feats, *jac = self._reduce(feats, *jac)
        return self._level_out(feats, lo, hi, step), tuple(
            self._level_out(j, lo, hi, step) for j in jac)

    def encode_axis_probes(self, u: torch.Tensor, u_probes: torch.Tensor,
                           probe_axes, step=None, levels=None,
                           grad_impl: str = "plain"):
        """A base point and axis-aligned FD probes from one 32-point
        neighbourhood gather per level (``encode_axis_probes`` of the JAX
        encoding).

        ``u`` [N, 3] in [0,1]^3; ``u_probes`` [P, N, 3], probe ``p``
        differing from ``u`` only along axis ``probe_axes[p]``, by at
        most one cell of every level in range.  The 32 points are the 8
        cell corners plus, per axis, the 8 points one cell before and
        after; each probe's trilinear interpolation is a [32] weight row
        over them.  One gather of [N, Lo, 32] rows (K1's layout period is
        32 * Lo).  Returns [P+1, N, L*F], base first."""
        lo, hi = self._level_range(levels, self.n_levels)
        p_n, n = len(probe_axes), u.shape[0]
        if u_probes.shape[0] != p_n:
            raise ValueError(f"{u_probes.shape[0]} probes for {p_n} axes")
        if hi <= lo:
            return u.new_zeros((p_n + 1, n, self.n_output_dims))
        trace.count("encode.chain_points", n * (p_n + 1))
        u, u_probes = self._enter(u, u_probes)
        i0, f = self._cell(u, lo, hi)
        res = self.level_res[lo:hi].to(u.dtype)
        w2 = _axis_pairs(f)
        zero8 = f.new_zeros((n, hi - lo, 8))
        rows = [torch.cat([_outer8(*w2), zero8, zero8, zero8], -1)]
        pos4 = torch.arange(4, device=u.device)
        for p, axis in enumerate(probe_axes):
            pa = u_probes[p, :, axis][:, None] * res[None, :]   # [N, Lo]
            i0p = torch.minimum(torch.floor(pa.detach()).clamp_(min=0.0),
                                res - 1.0)
            fp = (pa - i0p)[..., None]
            ox = (i0p.long() - i0[..., axis])[..., None]  # in {-1, 0, 1}
            # the probe's axis weights over positions -1, 0, 1, 2
            w4 = (pos4 == ox + 1) * (1.0 - fp) + (pos4 == ox + 2) * fp
            wb = list(w2)
            wb[axis] = w4[..., 1:3]
            others = [a for a in range(3) if a != axis]
            blocks = [_outer8(*wb), zero8, zero8, zero8]
            blocks[1 + axis] = _outer8(torch.stack([w4[..., 0], w4[..., 3]],
                                                   -1),
                                       w2[others[0]], w2[others[1]])
            rows.append(torch.cat(blocks, -1))
        w32 = torch.stack(rows)                        # [P+1, N, Lo, 32]
        c = torch.minimum(
            torch.clamp(i0[:, :, None, :] + self.off32, min=0),
            (self.dense_stride[lo:hi] - 1).view(1, -1, 1, 1))  # [N, Lo, 32, 3]

        def rows32(a, b):
            cc = c[:, a - lo:b - lo]
            return self._grid_rows(cc[..., 0], cc[..., 1], cc[..., 2], a, b)

        vals = self._lookup(self._rows_by_band(rows32, lo, hi), lo,
                            grad_impl)
        feats = self._reduce(torch.einsum("pnlk,nlkf->pnlf", w32, vals))
        return self._level_out(feats, lo, hi, step)


class EvalEncode(torch.autograd.Function):
    """``HashGridEncoding``'s features where no graph through the encode
    is kept: ``apply(x [N, 3], table [L, T, F] detached, levels)`` ->
    [N, L*F] on the card.  The forward is E1f and the backward E1b
    (``ops/hashgrid_eval.py``), one launch each; the table takes no
    gradient (no K1), and the position gradient is once-differentiable.
    Its plain counterpart is the chain (``HashGridEncoding._chain``)."""

    @staticmethod
    def forward(ctx, x, table, levels):
        x = x.contiguous()
        ctx.save_for_backward(x, table)
        ctx.levels = levels
        return hashgrid_eval.encode_features(x, table, levels)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, table = ctx.saved_tensors
        return (hashgrid_eval.encode_position_grad(x, table, grad,
                                                   ctx.levels), None, None)


class ReduceFrom(torch.autograd.Function):
    """Forward: the tensors summed over ``group`` (one all-reduce);
    backward: ``CopyTo`` of the replicated cotangents, which is the
    identity to first order.  ``ReduceFrom.bytes`` counts the bytes its
    all-reduces took, forward and backward."""

    bytes = 0

    @staticmethod
    def forward(ctx, group, *outs):
        ctx.group = group
        s = torch.stack(outs)
        dist.all_reduce(s, group=group)
        ReduceFrom.bytes += s.numel() * s.element_size()
        return tuple(s.unbind())

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + CopyTo.apply(ctx.group, *grads)


class CopyTo(torch.autograd.Function):
    """Forward: the tensors as they are (replicated over ``group``);
    backward: ``ReduceFrom`` of the shards' parts of their cotangents."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + ReduceFrom.apply(ctx.group, *grads)


def _axis_pairs(w: torch.Tensor):
    """Fractions [..., 3] -> per axis the linear weights (1 - w, w),
    three [..., 2] tensors."""
    return [torch.stack([1.0 - w[..., a], w[..., a]], -1) for a in range(3)]


def _outer8(wx, wy, wz) -> torch.Tensor:
    """Three [..., 2] axis weights -> [..., 8] corner weights (cx-major,
    matching the corner rows and the base block of the 32 points)."""
    return (wx[..., :, None, None] * wy[..., None, :, None]
            * wz[..., None, None, :]).flatten(-3)


def _off32() -> torch.Tensor:
    """[32, 3] offsets of the shared-probe neighbourhood: the 8 cell
    corners, then per axis (x, y, z) the points at -1 and 2 on that axis
    (e-major) with the other two axes at 0/1 in ascending order."""
    off = [[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    for axis in range(3):
        others = [a for a in range(3) if a != axis]
        for e in (-1, 2):
            for o1 in (0, 1):
                for o2 in (0, 1):
                    p = [0, 0, 0]
                    p[axis], p[others[0]], p[others[1]] = e, o1, o2
                    off.append(p)
    return torch.tensor(off, dtype=torch.int64)
