"""Reduction of a ``torch.profiler`` trace to busy time, the largest
device operations and the idle gaps by what the host was doing.

The reduction works on plain event tuples ``(name, on_device, start_us,
end_us, correlation)``; ``kineto_events`` makes them from a finished
profiler.  A device event's correlation id is that of the host runtime
call that launched it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

# name, on the device, start, end (microseconds), correlation id
Event = Tuple[str, bool, float, float, int]

STRETCH = "benchmark_stretch"  # the host span around the traced stretch


def kineto_events(prof) -> List[Event]:
    """The profiler's events as ``Event`` tuples (device events are
    kernels, copies and sets on the card; the rest ran on the host)."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        if on_device and e.is_user_annotation():
            continue  # a host range's shadow on the device, not work
        start = e.start_ns() / 1e3
        dur = e.duration_ns() / 1e3
        out.append((e.name(), on_device, start, start + dur,
                    int(e.correlation_id())))
    return out


def stretch_window(events: Iterable[Event]) -> Optional[Tuple[float, float]]:
    """(start, end) of the host span named ``STRETCH``."""
    for name, on_device, s, e, _ in events:
        if name == STRETCH and not on_device:
            return s, e
    return None


def _innermost(host, points):
    """For each of the ascending ``points``, the name of the host event
    with the latest start among those that contain it (the innermost,
    where events nest), or ``NO_HOST``; one sweep over the events
    sorted by start."""
    host = sorted(host)
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        inner = [e for e in stack[-8:] if e[1] >= t]
        out.append(max(inner)[2] if inner else NO_HOST)
    return out


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of ``intervals``."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


NO_HOST = "(no host event)"


def reduce(events: List[Event], top: int = 10) -> Dict:
    """Over the ``STRETCH`` span (without one, from the first event's
    start to the last one's end): its length ``window_s``, the union of
    the device intervals in it ``busy_s``, device seconds by operation
    name (``device_ops``, the ``top`` largest) and the idle gaps summed
    by the innermost host event running at each gap's middle
    (``idle_gaps``, the ``top`` largest; ``NO_HOST`` where the host ran
    nothing the trace records, such as Python between CUDA runtime
    calls in a trace without host operations)."""
    win = stretch_window(events)
    if win is None:
        if not events:
            raise ValueError("the trace is empty")
        win = (min(e[2] for e in events), max(e[3] for e in events))
    w0, w1 = win
    dev = sorted((max(s, w0), min(e, w1), n) for n, d, s, e, _ in events
                 if d and e > w0 and s < w1)
    host = [(s, e, n) for n, d, s, e, _ in events
            if not d and n != STRETCH and e > w0 and s < w1]
    busy = union_us([(s, e) for s, e, _ in dev])
    by_op = defaultdict(float)
    for s, e, n in dev:
        by_op[n] += e - s
    gaps, end = [], w0
    for s, e, _ in dev:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    by_host = defaultdict(float)
    for (g0, g1), name in zip(gaps, _innermost(host, [0.5 * (a + b)
                                                       for a, b in gaps])):
        by_host[name] += g1 - g0
    rank = lambda d: sorted(([k, v / 1e6] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "device_ops": rank(by_op), "idle_gaps": rank(by_host),
            "device_s_by_name": {k: v / 1e6 for k, v in by_op.items()}}


def device_seconds(reduced: Dict, *needles: str) -> float:
    """Device seconds of the operations whose names hold a needle."""
    return sum(v for k, v in reduced["device_s_by_name"].items()
               if any(n in k for n in needles))


def attributed_seconds(events, span: str) -> float:
    """Device seconds of the kernels launched inside the host spans
    named ``span``: each device event whose correlation id is that of a
    host runtime call made inside such a span."""
    spans = sorted((s, e) for n, d, s, e, _ in events if n == span and not d)
    if not spans:
        return 0.0
    starts = [s for s, _ in spans]
    corr = set()
    for n, d, s, e, c in events:
        if d or not c or n == span:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            corr.add(c)
    return sum(e - s for n, d, s, e, c in events if d and c in corr) / 1e6
