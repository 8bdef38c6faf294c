"""G1's (``csrc/gather_rows.cu``) share of its byte bound in a NeuS step."""

from benchmarks.yardstick import readers


def read(t):
    return readers.roofline_pct(t, "g1", "train")
