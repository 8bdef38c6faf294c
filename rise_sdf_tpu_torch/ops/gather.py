"""Row gather ``table[idx]``: kernel G1 and its plain version.

G1 (``csrc/gather_rows.cu``) replaces the Pallas TPU gathers
``pallas_row_gather`` and ``pallas_take_gather``
(``scripts/pallas_gather_bench.py``) and ``pallas_dma_gather``
(``scripts/r5_gather_width_bench.py``).  On the render path it serves
the hash-grid forward (``TableGradLookup``, 2-wide rows) and the
baked-SDF sample (``ops/sdf_bake.py``, 8-wide rows).

* ``gather_rows(table, idx)``: ``table [N, W]`` float32 (or float64)
  contiguous, rows of 8 bytes or of a multiple of 16, ``idx [M]`` int32
  -> ``[M, W]``.  On CUDA tensors it
  launches G1 or raises; on CPU tensors it runs ``gather_rows_plain``.
  ``gather_rows.launches`` counts kernel launches,
  ``gather_rows.launches16`` those of them on rows of 16-byte vectors
  (the baked-SDF sample's path; the rest take 8-byte rows).
* ``gather_rows_plain``: ``index_select``.

A negative index is an absent row (a row that another shard of a
row-sharded table owns, ``ops/hashgrid.py``): its output row is zeros.
A gather is exact: G1 copies bits, so it is bit-equal to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import trace

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .cuda_build import load_library

        lib = load_library("gather_rows")
        lib.rise_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.rise_gather_rows.restype = ctypes.c_int
        lib.rise_gather_error_string.argtypes = [ctypes.c_int]
        lib.rise_gather_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table.index_select(0, idx)``, the rows
    of absent (negative) indices clamped in and then zeroed."""
    idx = idx.long()
    absent = idx < 0
    if not bool(absent.any()):
        return table.index_select(0, idx)
    return table.index_select(0, idx.clamp(min=0)).masked_fill(
        absent[:, None], 0)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [N, W] float32/float64 contiguous; idx [M] int32 below N
    (a negative index gives a row of zeros) -> [M, W].  Launches on the
    current stream and does not synchronise."""
    with trace.span("kernel.g1"):
        return _gather_rows(table, idx)


def _gather_rows(table, idx):
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_rows takes int32 idx, got {idx.dtype}")
    if table.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"gather_rows takes a float32 or float64 table, "
                        f"got {table.dtype}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows takes table [N, W] and idx [M], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows takes a contiguous table and idx")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    # G1 takes 8-byte rows with idx 16-byte aligned, and rows of whole
    # 16-byte vectors with the table 16-byte aligned (the output is new,
    # so aligned); the CPU path holds callers to the same contract
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes == 8:
        if idx.data_ptr() % 16:
            raise ValueError("gather_rows takes 8-byte rows with idx "
                             "16-byte aligned")
    elif row_bytes % 16 == 0:
        if table.data_ptr() % 16:
            raise ValueError("gather_rows takes a 16-byte aligned table")
    else:
        raise ValueError(f"gather_rows takes rows of 8 bytes or of a "
                         f"multiple of 16 bytes, got {row_bytes}")
    if idx.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {idx.device}")
    (m,), (n, w) = idx.shape, table.shape
    out = torch.empty((m, w), dtype=table.dtype, device=table.device)
    if m == 0 or w == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.rise_gather_rows(idx.data_ptr(), table.data_ptr(),
                                  out.data_ptr(), m, row_bytes, n, stream)
    if rc != 0:
        raise RuntimeError("gather_rows kernel launch failed: "
                           + lib.rise_gather_error_string(rc).decode())
    gather_rows.launches += 1
    gather_rows.launches16 += int(row_bytes != 8)
    return out


gather_rows.launches = 0
gather_rows.launches16 = 0
