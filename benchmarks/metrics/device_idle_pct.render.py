"""The share of a traced image with the card idle."""

from benchmarks.yardstick import readers


def read(t):
    return readers.idle_pct(t, "render")
