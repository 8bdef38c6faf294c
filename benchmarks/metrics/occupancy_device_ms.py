"""Device time of the kernels an occupancy sweep launches
(``train.occupancy``), in ms per sweep."""

from benchmarks.yardstick import spans


def read(t):
    p = spans.record(t, "train")
    n = 0 if p is None else spans.n_spans(p, "train.occupancy")
    if not n or not spans.on_card(p):
        return None
    return 1e3 * spans.device_s(p, "train.occupancy") / n
