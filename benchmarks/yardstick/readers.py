"""What the per-layer metrics' readers (``metrics/<name>.py``) compute
from a traced run's record ``t`` (built by ``train.py`` or
``render.py`` and ``run.py``): each returns None where the run has nothing to
read, so the metric stays out of the line, and never 0 for a share."""

from __future__ import annotations

from . import roofline
from .peaks import FP32_FLOPS


def mfu_pct(t, kind: str):
    """The window's model FLOPs (``flops.py``, at its live samples) over
    its seconds and the float32 peak, in %."""
    if t["kind"] != kind or t["flops_seconds"] <= 0 or t["model_flops"] <= 0:
        return None
    return 100.0 * t["model_flops"] / (t["flops_seconds"] * FP32_FLOPS)


def span_ms(t, name: str):
    """The mean of the window's synchronised host spans ``name``, in ms."""
    spans = t["spans"].get(name) or []
    return 1e3 * sum(spans) / len(spans) if spans else None


def roofline_pct(t, kernel: str, kind: str = None):
    """``kernel``'s byte bound over its device time in the traced
    stretch, in %; None without a launch."""
    if kind is not None and t["kind"] != kind:
        return None
    return roofline.share_pct(t["launch_bytes"][kernel],
                              t["kernel_seconds"][kernel])


def idle_pct(t, kind: str):
    """The share of the traced stretch in which nothing ran on the card."""
    r = t["reduced"]
    if t["kind"] != kind or r["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
