"""K2's (``csrc/scatter_add_sorted.cu``) share of its byte bound."""

from benchmarks.yardstick import readers


def read(t):
    return readers.roofline_pct(t, "k2")
