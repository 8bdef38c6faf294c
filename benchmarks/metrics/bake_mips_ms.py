"""One image's mip build and SDF bake (``build_mips``, ``bake_eval_sdf``), in ms."""

from benchmarks.yardstick import readers


def read(t):
    return readers.span_ms(t, "bake_mips")
