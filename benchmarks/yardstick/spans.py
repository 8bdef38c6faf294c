"""Attribution of a traced stretch to the program's own stages.

The program's tracer (``rise_sdf_tpu_torch.trace``) records spans
``(name, id, parent, start_ns, end_ns, root)`` on the clock of the
profiler's events; a stretch traced without the host's operations
(device work and CUDA runtime calls, ``trace.Event`` tuples) is laid
under them:

* ``idle_attribution``: each idle gap of the card goes to the innermost
  span holding the gap's midpoint, or to none (``HARNESS``: the
  harness's own code, or the host outside any stage);
* ``kernel_attribution``: each device event goes to the innermost span
  holding the start of the runtime call that launched it (the host
  event with its correlation id), or to none.

``under`` gives the spans of a stage and of the stages inside it, so
that a stage's idle or device time takes in its children's.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from . import trace

HARNESS = "(harness)"


def _window(events: Sequence[trace.Event]) -> Tuple[float, float]:
    """The stretch (us), as ``trace.reduce`` takes it: the ``STRETCH``
    span, or the first event's start to the last one's end."""
    win = trace.stretch_window(events)
    if win is None:
        win = (min(e[2] for e in events), max(e[3] for e in events))
    return win


def window_s(record: dict) -> float:
    w0, w1 = _window(record["events"])
    return (w1 - w0) / 1e6


def _gaps(events: Sequence[trace.Event]) -> List[Tuple[float, float]]:
    """The card's idle intervals (us) over the stretch."""
    w0, w1 = _window(events)
    dev = sorted((max(s, w0), min(e, w1)) for _, d, s, e, _ in events
                 if d and e > w0 and s < w1)
    gaps, end = [], w0
    for s, e in dev:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if w1 > end:
        gaps.append((end, w1))
    return gaps


def innermost(spans: Iterable, points: Sequence[float]) -> List:
    """For each of the ascending ``points`` (us), the innermost span
    (the latest started of those holding it), or None.  Spans nest, so
    once the spans ended before a point are off the top of the stack of
    those started, the top holds it."""
    order = sorted(spans, key=lambda s: (s[3], -s[4]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(order) and order[i][3] / 1e3 <= t:
            stack.append(order[i])
            i += 1
        while stack and stack[-1][4] / 1e3 < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def idle_attribution(events: Sequence[trace.Event], spans: Iterable
                     ) -> List[Tuple[Optional[tuple], float]]:
    """``(span or None, seconds)`` for each idle gap of the stretch."""
    gaps = _gaps(events)
    mids = [0.5 * (a + b) for a, b in gaps]
    return [(s, (b - a) / 1e6)
            for s, (a, b) in zip(innermost(spans, mids), gaps)]


def kernel_attribution(events: Sequence[trace.Event], spans: Iterable
                       ) -> List[Tuple[Optional[tuple], trace.Event]]:
    """``(span or None, device event)`` for each device event."""
    launch = {c: s for _, d, s, _, c in events if not d and c}
    dev = [e for e in events if e[1]]
    starts = sorted({launch[e[4]] for e in dev if e[4] in launch})
    where = dict(zip(starts, innermost(spans, starts)))
    return [(where.get(launch.get(e[4])), e) for e in dev]


def under(spans: Iterable, name: str) -> Set[int]:
    """The ids of the spans named ``name`` and of every span inside
    one of them."""
    spans = list(spans)
    children = defaultdict(list)
    for s in spans:
        children[s[2]].append(s[1])
    out, todo = set(), [s[1] for s in spans if s[0] == name]
    while todo:
        i = todo.pop()
        out.add(i)
        todo.extend(children[i])
    return out


def idle_by_name(events, spans) -> Dict[str, float]:
    """Idle seconds by the innermost span's name (``HARNESS``: none)."""
    out = defaultdict(float)
    for s, v in idle_attribution(events, spans):
        out[HARNESS if s is None else s[0]] += v
    return dict(out)


def device_by_name(events, spans) -> Dict[str, float]:
    """Device seconds by the launching span's name (``HARNESS``: none)."""
    out = defaultdict(float)
    for s, e in kernel_attribution(events, spans):
        out[HARNESS if s is None else s[0]] += (e[3] - e[2]) / 1e6
    return dict(out)


def idle_s(record: dict, name: str) -> float:
    """Idle seconds of the card in the gaps whose midpoints lie in a
    span ``name`` (or a stage inside it)."""
    ids = under(record["spans"], name)
    return sum(v for s, v in idle_attribution(record["events"],
                                              record["spans"])
               if s is not None and s[1] in ids)


def device_s(record: dict, *names: str) -> float:
    """Device seconds of the kernels launched in the spans ``names`` (or
    in a stage inside one of them)."""
    ids = set().union(*(under(record["spans"], n) for n in names))
    return sum((e[3] - e[2]) / 1e6
               for s, e in kernel_attribution(record["events"],
                                              record["spans"])
               if s is not None and s[1] in ids)


def n_spans(record: dict, name: str) -> int:
    return sum(1 for s in record["spans"] if s[0] == name)



def record(t: dict, kind: str) -> Optional[dict]:
    """The traced record's stretch with the program's tracer on
    (``stages.py``), where the run is of ``kind`` and made one."""
    p = t.get("program")
    return p if p is not None and t["kind"] == kind else None


def on_card(p: dict) -> bool:
    """Whether the card ran anything in the stretch (a CPU run has no
    device events, and so no device time or idle time)."""
    return any(e[1] for e in p["events"])
