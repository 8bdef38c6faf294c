"""A NeuS train step's share of the float32 peak over the traced
stretch, at the samples the buffers kept and the rays included as the
program counts them (``model.samples_kept``, ``model.rays_included``)."""

from benchmarks.yardstick import spans
from benchmarks.yardstick.peaks import FP32_FLOPS


def read(t):
    p = spans.record(t, "train")
    if p is None or p["model_flops"] <= 0:
        return None
    return 100.0 * p["model_flops"] / (spans.window_s(p) * FP32_FLOPS)
