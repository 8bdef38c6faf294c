"""The render chunks' share of the float32 peak."""

from benchmarks.yardstick import readers


def read(t):
    return readers.mfu_pct(t, "render")
