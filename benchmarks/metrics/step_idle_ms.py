"""The card's idle time in a NeuS step (``train.step`` spans), in ms,
from the stretch with the program's tracer on."""

from benchmarks.yardstick import spans


def read(t):
    p = spans.record(t, "train")
    n = 0 if p is None else spans.n_spans(p, "train.step")
    if not n or not spans.on_card(p):
        return None
    return 1e3 * spans.idle_s(p, "train.step") / n
