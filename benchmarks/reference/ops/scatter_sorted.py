"""Deterministic scatter-add: kernel K2 and its plain version, and the
gathers whose backward it is.

In this frozen copy ``scatter_add_sorted`` takes
``scatter_add_sorted_plain`` on every device (no kernel is built or
launched).

Counterpart of the table gradient of ``grad_impl='sorted'`` in
``rise_sdf_tpu/ops/hashgrid.py`` (``_encode_sorted_vjp``: argsort, a
float32 prefix sum, searchsorted), which is XLA ops in the JAX package.

* ``scatter_add_sorted(idx, vals, table_size, period=1)``: a zeroed
  ``[table_size, F]`` table with every ``vals`` row added at its
  ``idx``, bit-reproducibly.  The sum is exact fixed-point arithmetic:
  each entry of the table gets a power-of-two scale from the largest
  magnitude that reaches it (to within a bucket of W binades), every
  value becomes an integer on its entry's scale, split into a signed
  high and an unsigned low 32-bit word, and the words are summed as
  64-bit integers, which is exact in any order; each entry is converted
  back and rounded once to ``vals``' dtype.  Against the exact sum an
  entry is within one ulp of that dtype plus ``count * 2^-(93 -
  bitlen(M) - W)`` of its own largest magnitude (W = 9 for float32:
  2^-56 at M = 2^27), however far below the call's largest it lies; a
  row whose sum is -0.0 may come out +0.0.  A NaN or an infinity makes
  its entry NaN (a NaN, or both infinities) or that infinity, as a
  float sum would.  On CUDA tensors it launches the hand-written kernel
  ``csrc/scatter_add_sorted.cu`` (passes: zero the scratch; the range
  of float64 values; K1's column walk twice, for each entry's bucket
  and for the sums, with 64-bit atomics; the conversion) or raises; on
  CPU tensors it runs ``scatter_add_sorted_plain``, which is the same
  arithmetic in torch ops, so the two are bit-equal.  ``period`` is the
  row stride of the caller's layout, as K1's: it changes how the kernel
  walks the entries, not a bit of the result.  A negative index is an
  absent row (a row that another shard of a row-sharded table owns,
  ``ops/hashgrid.py``): its values take part in nothing, neither the
  range nor a bucket nor a sum; M counts every entry.
  ``scatter_add_sorted.launches`` counts calls that launched the kernel.
* ``scatter_add_sorted_plain``: the kernel's arithmetic with
  ``index_add_`` on int64 tensors.
* ``index_select(x, idx)``: ``x.index_select(0, idx)``.  Under
  ``torch.use_deterministic_algorithms(True)`` its backward is
  ``scatter_add_sorted`` (torch's is an atomic ``index_add_``), and the
  backward's backward is again this gather.

The port has no switch of its own: it reads torch's,
``torch.are_deterministic_algorithms_enabled()``.
"""

from __future__ import annotations

import math

import torch

# the most rows of one call: the sums of the low words stay under 2^62,
# below the two flag bits of their word
MAX_ROWS = 1 << 30
# the kernel's passes, as the bits of its ``passes`` argument
PASSES = {"zero": 1, "range": 2, "buckets": 4, "scatter": 8, "convert": 16}
# bucket bits in an entry's mask: 32 buckets of W binades each, over all
# of float32's exponents (W = 9) or over the range of the call's finite
# nonzero float64 magnitudes
_BUCKETS = 32




def _pow2(k: torch.Tensor) -> torch.Tensor:
    """``2^k`` as float64 from its bits, for int64 ``k`` in [-1022,
    1023]."""
    return ((k + 1023) << 52).view(torch.float64)


def _times_pow2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x * 2^k`` as the kernel takes it: two power-of-two products,
    ``2^k1`` (``k`` clamped to [-1000, 1000]) and then ``2^(k - k1)``,
    each a float64 multiply."""
    k1 = k.clamp(-1000, 1000)
    return x * _pow2(k1) * _pow2(k - k1)


def present_entries(idx: torch.Tensor, vals: torch.Tensor):
    """``idx`` and ``vals`` without the entries of absent (negative)
    indices."""
    keep = idx >= 0
    if bool(keep.all()):
        return idx, vals
    return idx[keep], vals[keep]


def scatter_add_sorted_plain(idx: torch.Tensor, vals: torch.Tensor,
                             table_size: int) -> torch.Tensor:
    """Plain PyTorch version, bit-equal to the kernel (its header has the
    arithmetic): each entry's scale from the range of the call and the
    bucket of its largest value, every value quantised on its entry's
    scale, ``index_add_`` of the high and the low words as int64, each
    entry converted back and rounded once to ``vals``' dtype."""
    m, f = vals.shape  # M counts the absent entries too
    table = (table_size, f)
    dev = vals.device
    idx, vals = present_entries(idx, vals)
    if vals.numel() == 0:
        return torch.zeros(table, dtype=vals.dtype, device=dev)
    finite = torch.isfinite(vals)
    x = torch.where(finite, vals, 0).double()
    nonzero = x != 0
    if vals.dtype == torch.float32:
        e_hi, width = 128, 9
    else:
        a = x.abs()
        e_hi = math.frexp(float(a.max()))[1]
        e_lo = math.frexp(float(a[nonzero].min()))[1] \
            if bool(nonzero.any()) else e_hi
        width = (e_hi - e_lo + _BUCKETS) // _BUCKETS
        del a
    # frexp's exponent e: |x| < 2^e
    bucket = torch.where(nonzero, ((e_hi - torch.frexp(x).exponent.long())
                                   // width).clamp(max=_BUCKETS - 1),
                         _BUCKETS)
    rows = idx.long()
    least = torch.full(table, _BUCKETS, dtype=torch.int64,
                       device=dev).scatter_reduce_(
        0, rows[:, None].expand(-1, f), bucket, "amin")
    del bucket
    shift = (94 - m.bit_length()) - (e_hi - width * torch.where(
        least == _BUCKETS, 0, least))
    q = _times_pow2(x, shift[rows]).round_()
    del x
    hi = (q * 2.0 ** -32).floor_()
    lo = q.sub_(hi * 2.0 ** 32).long()
    words = [torch.zeros(table, dtype=torch.int64, device=dev).index_add_(
        0, rows, w) for w in (hi.long(), lo)]
    del q, hi, lo
    high = words[0] + (words[1] >> 32)
    d = high.double() * 2.0 ** 32 + (words[1] & 0xffffffff).double()
    out = _times_pow2(d, -shift).to(vals.dtype)
    if not bool(finite.all()):
        nan = torch.isnan(vals)
        pos, neg = (torch.zeros(table, dtype=torch.int64, device=dev
                                ).index_add_(0, rows, (nan | (vals == inf))
                                             .long()) > 0
                    for inf in (math.inf, -math.inf))
        out = out.masked_fill(pos, math.inf).masked_fill(neg, -math.inf) \
            .masked_fill(pos & neg, math.nan)
    return out


def scatter_add_sorted(idx: torch.Tensor, vals: torch.Tensor,
                       table_size: int, period: int = 1) -> torch.Tensor:
    """idx [M] int32 below table_size (a negative index is dropped), M <=
    ``MAX_ROWS``; vals [M, F]
    float32 or float64 -> [table_size, F] of vals' dtype,
    bit-reproducible.  ``period`` >= 1: entry ``n * period + j`` of
    ``idx`` is row ``n``, column ``j`` of the caller's layout.  Launches
    on the current stream and does not synchronise."""
    out, run = _prepare(idx, vals, table_size, period)
    if run is None:
        return out
    run(31)
    scatter_add_sorted.launches += 1
    return out


scatter_add_sorted.launches = 0


def _prepare(idx, vals, table_size, period):
    """Check the arguments; -> (the output, None) on the CPU or for an
    empty table, else (the output, ``run(passes)``, which launches the
    kernel's passes named by the bits of ``passes`` into it and raises
    if a launch fails)."""
    if isinstance(period, bool) or not isinstance(period, int):
        raise TypeError(f"scatter_add_sorted takes an int period, got "
                        f"{period!r}")
    if period < 1:
        raise ValueError(f"scatter_add_sorted takes a period >= 1, got "
                         f"{period}")
    if idx.dtype != torch.int32 or vals.dtype not in (torch.float32,
                                                      torch.float64):
        raise TypeError(f"scatter_add_sorted takes int32 idx and float32 or "
                        f"float64 vals, got {idx.dtype} and {vals.dtype}")
    if idx.dim() != 1 or vals.dim() != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_add_sorted takes idx [M] and vals [M, F], "
                         f"got {tuple(idx.shape)} and {tuple(vals.shape)}")
    if idx.shape[0] > MAX_ROWS:
        raise ValueError(f"scatter_add_sorted takes at most {MAX_ROWS} rows, "
                         f"got {idx.shape[0]}")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_add_sorted takes contiguous idx and vals")
    if idx.device != vals.device:
        raise ValueError(f"idx on {idx.device}, vals on {vals.device}")
    return scatter_add_sorted_plain(idx, vals, table_size), None




class _Select(torch.autograd.Function):
    """``x.index_select(0, idx)`` whose backward is ``_Scatter``."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _Scatter.apply(grad, idx, ctx.shape), None


class _Scatter(torch.autograd.Function):
    """K2 of ``grad`` at ``idx`` into ``shape``, whose backward is
    ``_Select``."""

    @staticmethod
    def forward(ctx, grad, idx, shape):
        ctx.save_for_backward(idx)
        return scatter_add_sorted(
            idx.to(torch.int32).contiguous(),
            grad.reshape(grad.shape[0], -1).contiguous(),
            shape[0]).reshape(shape)

    @staticmethod
    def backward(ctx, gg):
        (idx,) = ctx.saved_tensors
        return _Select.apply(gg, idx), None, None


def index_select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.index_select(0, idx)``; under the deterministic switch, when a
    gradient will be taken, its backward is K2."""
    if torch.are_deterministic_algorithms_enabled() \
            and torch.is_grad_enabled() and x.requires_grad:
        return _Select.apply(x, idx)
    return x.index_select(0, idx)
