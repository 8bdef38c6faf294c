"""The share of a traced sweep period of NeuS steps with the card idle."""

from benchmarks.yardstick import readers


def read(t):
    return readers.idle_pct(t, "train")
