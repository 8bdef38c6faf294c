"""Deterministic scatter-add: kernel K2 and its plain version, and the
gathers whose backward it is.

Counterpart of the table gradient of ``grad_impl='sorted'`` in
``rise_sdf_tpu/ops/hashgrid.py`` (``_encode_sorted_vjp``: argsort, a
float32 prefix sum, searchsorted), which is XLA ops in the JAX package.

* ``scatter_add_sorted(idx, vals, table_size)``: a zeroed ``[table_size,
  F]`` table with every ``vals`` row added at its ``idx``, each row's sum
  taken in float64 in an order fixed by the input alone, so the result
  repeats bit for bit.  On CUDA tensors it sorts ``idx`` with
  ``torch.sort(stable=True)`` and launches the hand-written segmented
  sum ``csrc/scatter_add_sorted.cu`` or raises; on CPU tensors it runs
  ``scatter_add_sorted_plain``.  ``scatter_add_sorted.launches`` counts
  kernel launches.
* ``scatter_add_sorted_plain``: ``index_add_`` in float64, rounded once
  to ``vals``' dtype.
* ``index_select(x, idx)``: ``x.index_select(0, idx)``.  Under
  ``torch.use_deterministic_algorithms(True)`` its backward is
  ``scatter_add_sorted`` (torch's is an atomic ``index_add_``), and the
  backward's backward is again this gather.

The port has no switch of its own: it reads torch's,
``torch.are_deterministic_algorithms_enabled()``.
"""

from __future__ import annotations

import ctypes

import torch

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library

        lib = load_library("scatter_add_sorted")
        lib.rise_scatter_add_sorted.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.rise_scatter_add_sorted.restype = ctypes.c_int
        lib.rise_scatter_add_sorted_workspace.argtypes = [ctypes.c_longlong]
        lib.rise_scatter_add_sorted_workspace.restype = ctypes.c_longlong
        lib.rise_scatter_add_sorted_error_string.argtypes = [ctypes.c_int]
        lib.rise_scatter_add_sorted_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def scatter_add_sorted_plain(idx: torch.Tensor, vals: torch.Tensor,
                             table_size: int) -> torch.Tensor:
    """Plain PyTorch version: ``zeros([T, F], float64).index_add_(0, idx,
    vals)`` rounded to ``vals``' dtype."""
    return torch.zeros((table_size, vals.shape[-1]), dtype=torch.float64,
                       device=vals.device).index_add_(
        0, idx.long(), vals.double()).to(vals.dtype)


def scatter_add_sorted(idx: torch.Tensor, vals: torch.Tensor,
                       table_size: int) -> torch.Tensor:
    """idx [M] int32 in [0, table_size); vals [M, F] float32 or float64
    -> [table_size, F] of vals' dtype, bit-reproducible.  Launches on the
    current stream and does not synchronise."""
    if idx.dtype != torch.int32 or vals.dtype not in (torch.float32,
                                                      torch.float64):
        raise TypeError(f"scatter_add_sorted takes int32 idx and float32 or "
                        f"float64 vals, got {idx.dtype} and {vals.dtype}")
    if idx.dim() != 1 or vals.dim() != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_add_sorted takes idx [M] and vals [M, F], "
                         f"got {tuple(idx.shape)} and {tuple(vals.shape)}")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_add_sorted takes contiguous idx and vals")
    if idx.device != vals.device:
        raise ValueError(f"idx on {idx.device}, vals on {vals.device}")
    if idx.device.type == "cpu":
        return scatter_add_sorted_plain(idx, vals, table_size)
    if idx.device.type != "cuda":
        raise ValueError(f"scatter_add_sorted runs on cpu or cuda, not "
                         f"{idx.device}")
    m, f = vals.shape
    out = torch.zeros((table_size, f), dtype=vals.dtype, device=vals.device)
    if m == 0 or f == 0:
        return out
    lib = _lib()
    keys, order = torch.sort(idx, stable=True)
    half = lib.rise_scatter_add_sorted_workspace(m)
    ws_keys = torch.empty(2 * half, dtype=torch.int32, device=vals.device)
    ws_vals = torch.empty(2 * half * f, dtype=torch.float64,
                          device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.rise_scatter_add_sorted(
            keys.data_ptr(), order.data_ptr(), vals.data_ptr(),
            int(vals.dtype == torch.float64), m, f, out.data_ptr(),
            table_size, ws_keys.data_ptr(), ws_vals.data_ptr(), half, stream)
    if rc != 0:
        raise RuntimeError("scatter_add_sorted kernel launch failed: "
                           + lib.rise_scatter_add_sorted_error_string(
                               rc).decode())
    scatter_add_sorted.launches += 1
    return out


scatter_add_sorted.launches = 0


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
