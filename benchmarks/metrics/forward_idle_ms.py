"""The card's idle time in an image's eval chunks (``model.forward``
spans), in ms per image, from the stretch with the program's tracer
on."""

from benchmarks.yardstick import spans


def read(t):
    p = spans.record(t, "render")
    if p is None or not spans.on_card(p):
        return None
    return 1e3 * spans.idle_s(p, "model.forward") / p["periods"]
