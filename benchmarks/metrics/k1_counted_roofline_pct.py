"""K1's share of its byte bound, from the program's own byte counter
(``kernel.k1.bytes``) over the device time of the kernels launched in
``kernel.k1`` spans."""

from benchmarks.yardstick import roofline, spans


def read(t):
    p = spans.record(t, "train")
    if p is None:
        return None
    return roofline.share_pct(sum(p["counts"].get("kernel.k1.bytes", [])),
                              spans.device_s(p, "kernel.k1"))
