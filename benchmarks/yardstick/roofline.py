"""Byte bounds of the hand-written kernels, from each launch's shapes.

Every index and value is read once, the output written once and, for a
gather, each distinct table row read once (the byte bound of the
port's kernel table, at 3.35 TB/s).  The count is of what the inputs
need, so it reads the same whatever kernel does the work.
"""

from __future__ import annotations

from .peaks import HBM_BYTES_PER_S


def gather_bytes(rows: int, row_bytes: int, distinct: int,
                 index_bytes: int = 4) -> int:
    """``table[idx]``: ``rows`` indices read, ``rows`` output rows
    written, ``distinct`` table rows read."""
    return rows * index_bytes + rows * row_bytes + distinct * row_bytes


def scatter_bytes(rows: int, features: int, table_rows: int,
                  value_bytes: int = 4, index_bytes: int = 4) -> int:
    """``zeros[T, F].at[idx].add(vals)``: ``rows`` indices and value
    rows read, the ``[T, F]`` output written."""
    return rows * (index_bytes + features * value_bytes) \
        + table_rows * features * value_bytes


def bound_s(nbytes: int) -> float:
    """The least time the chip's memory can move ``nbytes`` in."""
    return nbytes / HBM_BYTES_PER_S


def share_pct(nbytes: int, device_s: float):
    """Roofline share in %: the byte bound over the kernels' device
    time; None when no time was measured (no launch in the stretch)."""
    if device_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * bound_s(nbytes) / device_s
