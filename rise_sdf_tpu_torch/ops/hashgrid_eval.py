"""The hash-grid encode where no graph is kept: kernels E1f and E1b.

E1 (``csrc/hashgrid_eval.cu``) replaces no TPU kernel: the JAX package
leaves the encode's arithmetic around its gathers to XLA.  It computes
the features of points and their position gradient in two launches,
with no table gradient, in place of the torch chain around G1 in
``ops/hashgrid.py``; ``hashgrid.EvalEncode`` calls it.

* ``encode_features(x, table, levels)``: ``x [N, 3]`` float32 in [0,
  1]^3, ``table [L, T, 2]`` float32 -> ``[N, L * 2]`` features, bit-equal
  to the chain's on the card.  ``encode_features.launches`` counts
  launches.
* ``encode_position_grad(x, table, grad, levels)``: the cotangent
  ``grad [N, L * 2]`` of those features -> ``[N, 3]``, the gradient
  autograd takes through the chain.  ``encode_position_grad.launches``
  counts launches.
* ``Levels``: the level constants both take (resolutions, dense
  strides, the progressive mask, the range, the dense prefix, T).

Both launch on CUDA tensors or raise: the plain counterpart is the
chain itself, which ``HashGridEncoding`` runs on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from .. import trace

_LIB = None
MAX_LEVELS = 32


class Levels(NamedTuple):
    res: Sequence[float]      # per level, an integer
    stride: Sequence[int]     # per level, res + 1
    mask: Sequence[float]     # per level, 1.0 open or 0.0 closed
    lo: int
    hi: int
    n_dense: int              # levels below it index densely
    table_size: int           # T, a power of two

    def args(self):
        """The ctypes arguments from ``res`` to ``hash_mask``."""
        n = len(self.res)
        return ((ctypes.c_float * n)(*self.res),
                (ctypes.c_int * n)(*self.stride),
                (ctypes.c_float * n)(*self.mask), n, self.lo, self.hi,
                self.n_dense, self.table_size, self.table_size - 1)


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library

        lib = load_library("hashgrid_eval")
        levels = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.rise_encode_features.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong] + levels
        lib.rise_encode_features.restype = ctypes.c_int
        lib.rise_encode_position_grad.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong] + levels
        lib.rise_encode_position_grad.restype = ctypes.c_int
        lib.rise_encode_error_string.argtypes = [ctypes.c_int]
        lib.rise_encode_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x, table, levels: Levels):
    if x.device.type != "cuda":
        raise ValueError(f"the eval encode kernels run on cuda, not "
                         f"{x.device}: the plain counterpart is the chain")
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"the eval encode takes float32 x and table, got "
                        f"{x.dtype} and {table.dtype}")
    n_levels = len(levels.res)
    if x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"the eval encode takes contiguous x [N, 3], got "
                         f"{tuple(x.shape)}")
    if (table.dim() != 3 or tuple(table.shape) != (n_levels,
                                                   levels.table_size, 2)
            or not table.is_contiguous() or table.data_ptr() % 8):
        raise ValueError(f"the eval encode takes a contiguous, 8-byte "
                         f"aligned table [{n_levels}, {levels.table_size}, "
                         f"2], got {tuple(table.shape)}")
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"the eval encode takes 1 to {MAX_LEVELS} levels, "
                         f"not {n_levels}")
    if table.device != x.device:
        raise ValueError(f"x on {x.device}, table on {table.device}")


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _lib().rise_encode_error_string(rc).decode())


def encode_features(x: torch.Tensor, table: torch.Tensor,
                    levels: Levels) -> torch.Tensor:
    """E1f: x [N, 3], table [L, T, 2] -> features [N, L * 2] (zeros
    outside ``levels``' range).  Launches on the current stream and does
    not synchronise."""
    with trace.span("kernel.e1"):
        _check(x, table, levels)
        n = x.shape[0]
        out = torch.empty((n, 2 * len(levels.res)), dtype=torch.float32,
                          device=x.device)
        if n == 0:
            return out
        lib = _lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.rise_encode_features(x.data_ptr(), table.data_ptr(),
                                          out.data_ptr(), n, *levels.args(),
                                          stream)
        _raise_on(rc, "encode_features")
        encode_features.launches += 1
        return out


def encode_position_grad(x: torch.Tensor, table: torch.Tensor,
                         grad: torch.Tensor, levels: Levels) -> torch.Tensor:
    """E1b: the cotangent grad [N, L * 2] of ``encode_features(x, table,
    levels)`` -> d x [N, 3].  ``grad`` may be a column slice (rows of any
    stride).  Launches on the current stream and does not synchronise."""
    with trace.span("kernel.e1"):
        _check(x, table, levels)
        n, width = x.shape[0], 2 * len(levels.res)
        if tuple(grad.shape) != (n, width) or grad.dtype != torch.float32 \
                or grad.device != x.device:
            raise ValueError(f"the eval encode's cotangent is float32 [{n}, "
                             f"{width}] on {x.device}, got {grad.dtype} "
                             f"{tuple(grad.shape)} on {grad.device}")
        if n > 0 and (grad.stride(1) != 1 or grad.stride(0) < width):
            grad = grad.contiguous()
        out = torch.empty((n, 3), dtype=torch.float32, device=x.device)
        if n == 0:
            return out
        lib = _lib()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.rise_encode_position_grad(
                x.data_ptr(), table.data_ptr(), grad.data_ptr(),
                grad.stride(0), out.data_ptr(), n, *levels.args(), stream)
        _raise_on(rc, "encode_position_grad")
        encode_position_grad.launches += 1
        return out


encode_features.launches = 0
encode_position_grad.launches = 0
