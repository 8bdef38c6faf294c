"""Hash-table gradient scatter-add: kernel K1 and its plain version.

Counterpart of ``rise_sdf_tpu/ops/scatter_pallas.py``.

* ``scatter_add(idx, vals, table_size, period=1)``: zeroed
  ``[table_size, F]`` float32 table with every ``vals`` row added at its
  ``idx``.  On CUDA tensors it launches the hand-written kernel
  ``csrc/scatter_add.cu`` (replaces the Pallas kernel
  ``pallas_scatter_add``) or raises; on CPU tensors it runs
  ``scatter_add_plain``.  ``period`` is the row stride of the caller's
  layout (entry ``n * period + j``): the kernel adds up runs of equal
  rows down each column ``j`` before its atomics.  It changes the order
  of the float32 sums, not what is summed.  ``scatter_add.launches``
  counts kernel launches.
* ``scatter_add_plain``: ``index_add_`` (counterpart of
  ``scatter_add_reference``).
* A negative index is an absent row (a row that another shard of a
  row-sharded table owns, ``ops/hashgrid.py``): both drop its values,
  as XLA's scatter drops an out-of-bounds index.
* ``TableGradLookup``: ``table[idx]`` (kernel G1, ``ops/gather.py``, on
  the card) whose table-gradient is ``scatter_add``, or with
  ``grad_impl='sorted'`` (and always under
  ``torch.use_deterministic_algorithms(True)``) the deterministic
  ``scatter_add_sorted`` (K2, ``ops/scatter_sorted.py``), both walking
  the same ``period``.  First-order
  in the table, which is all the losses
  need: position gradients flow through the interpolation weights, so
  the table side of the gather is differentiated exactly once even
  under the eikonal loss's double backward.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .. import trace
from .gather import gather_rows
from .scatter_sorted import present_entries, scatter_add_sorted

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library

        lib = load_library("scatter_add")
        lib.rise_scatter_add_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.rise_scatter_add_f32.restype = ctypes.c_int
        lib.rise_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rise_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def scatter_bytes(rows: int, features: int, table_size: int) -> int:
    """The bytes a scatter-add of float32 ``[rows, features]`` values
    into ``[table_size, features]`` needs: each int32 index and value
    read once, the table written once."""
    return rows * (4 + 4 * features) + table_size * features * 4


def scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor,
                      table_size: int) -> torch.Tensor:
    """Plain PyTorch version: ``zeros([T, F]).index_add_(0, idx, vals)``
    over the present (non-negative) indices."""
    idx, vals = present_entries(idx, vals)
    return torch.zeros((table_size, vals.shape[-1]), dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx.long(), vals)



def scatter_add(idx: torch.Tensor, vals: torch.Tensor, table_size: int,
                period: int = 1) -> torch.Tensor:
    """idx [M] int32 below table_size (a negative index is dropped);
    vals [M, F] float32 -> [table_size, F] float32.  ``period`` >= 1: entry ``n * period + j``
    of ``idx`` is row ``n``, column ``j`` of the caller's layout (the
    kernel adds the entries past the last whole row one by one).
    Launches on the current stream and does not synchronise."""
    with trace.span("kernel.k1"):
        return _scatter_add(idx, vals, table_size, period)


def _scatter_add(idx, vals, table_size, period):
    if isinstance(period, bool) or not isinstance(period, int):
        raise TypeError(f"scatter_add takes an int period, got {period!r}")
    if period < 1:
        raise ValueError(f"scatter_add takes a period >= 1, got {period}")
    if idx.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"scatter_add takes int32 idx and float32 vals, got "
                        f"{idx.dtype} and {vals.dtype}")
    if idx.dim() != 1 or vals.dim() != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_add takes idx [M] and vals [M, F], got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_add takes contiguous idx and vals")
    if idx.device != vals.device:
        raise ValueError(f"idx on {idx.device}, vals on {vals.device}")
    if trace.on():
        trace.count("kernel.k1.bytes", scatter_bytes(
            idx.shape[0], vals.shape[1], table_size))
    if idx.device.type == "cpu":
        return scatter_add_plain(idx, vals, table_size)
    if idx.device.type != "cuda":
        raise ValueError(f"scatter_add runs on cpu or cuda, not {idx.device}")
    m, f = vals.shape
    out = torch.zeros((table_size, f), dtype=torch.float32, device=vals.device)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.rise_scatter_add_f32(idx.data_ptr(), vals.data_ptr(),
                                      out.data_ptr(), m, f, table_size,
                                      period, stream)
    if rc != 0:
        raise RuntimeError("scatter_add kernel launch failed: "
                           + lib.rise_cuda_error_string(rc).decode())
    scatter_add.launches += 1
    return out


scatter_add.launches = 0


GRAD_IMPLS = ("plain", "sorted")


class TableGradLookup(torch.autograd.Function):
    """``table[idx]`` (rows of a ``[T, F]`` table) with a G1 forward and
    a K1 backward, or a K2 backward when ``sorted_grad``."""

    @staticmethod
    def forward(ctx, table, idx, sorted_grad=False):
        ctx.save_for_backward(idx)
        ctx.table_size = table.shape[0]
        ctx.sorted_grad = sorted_grad
        return gather_rows(table.contiguous(), idx.reshape(-1)).view(
            *idx.shape, table.shape[1])

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        f = grad.shape[-1]
        # the encodes' [N, L_open, 8] corner rows and [N, L_open, 32]
        # probe-neighbourhood rows: one sample's levels per row of the
        # layout, consecutive samples along a ray
        period = idx.shape[-2] * idx.shape[-1] \
            if idx.dim() == 3 and idx.shape[-1] in (8, 32) else 1
        scatter_fn = scatter_add_sorted if ctx.sorted_grad else scatter_add
        d_table = scatter_fn(idx.reshape(-1),
                             grad.reshape(-1, f).float().contiguous(),
                             ctx.table_size, period)
        return d_table.to(grad.dtype), None, None


def table_grad_lookup(table: torch.Tensor, idx: torch.Tensor,
                      grad_impl: str = "plain") -> torch.Tensor:
    """``table [T, F]``, ``idx [...]`` int32 -> ``[..., F]``.  The table
    gradient is K1's (``grad_impl='plain'``) or K2's (``'sorted'``, and
    whenever the deterministic switch is on)."""
    if grad_impl not in GRAD_IMPLS:
        raise ValueError(f"grad_impl is one of {GRAD_IMPLS}, not "
                         f"{grad_impl!r}")
    return TableGradLookup.apply(
        table, idx,
        grad_impl == "sorted" or torch.are_deterministic_algorithms_enabled())
