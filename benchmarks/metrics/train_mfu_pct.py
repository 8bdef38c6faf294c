"""A NeuS train step's share of the float32 peak (``yardstick/flops.py``)."""

from benchmarks.yardstick import readers


def read(t):
    return readers.mfu_pct(t, "train")
