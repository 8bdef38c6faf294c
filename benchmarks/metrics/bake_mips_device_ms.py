"""Device time of the kernels an image's mip build and SDF bake launch
(``eval.build_mips``, ``eval.bake``), in ms per image."""

from benchmarks.yardstick import spans


def read(t):
    p = spans.record(t, "render")
    if p is None or not spans.on_card(p):
        return None
    return 1e3 * spans.device_s(p, "eval.build_mips", "eval.bake") \
        / p["periods"]
