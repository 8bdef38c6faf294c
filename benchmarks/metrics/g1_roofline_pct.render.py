"""G1's share of its byte bound in the render (both of its paths)."""

from benchmarks.yardstick import readers


def read(t):
    return readers.roofline_pct(t, "g1", "render")
