"""One occupancy sweep (``systems/base.py`` ``update_occupancy``), in ms."""

from benchmarks.yardstick import readers


def read(t):
    return readers.span_ms(t, "occupancy")
