"""Spans and counters of the program's stages, on the clock of
``torch.profiler``'s events.

Off by default.  ``recording()`` turns the tracer on for its body and
yields the ``Record`` that receives what the body's stages report::

    with trace.recording() as rec:
        system.train_step(state, batch)
    rec.spans   # [Span(name, id, parent, start_ns, end_ns, root)]
    rec.counts  # {name: [one value a call]}

* ``span(name)`` is a context manager around a stage.  Off, it returns
  the one shared ``NO_SPAN`` and reads no clock; on, the span's start
  and end are ``time.time_ns()``, the Unix clock in nanoseconds that the
  profiler's Kineto events carry (``start_ns()``), so a span can be laid
  over a trace of the card's kernels.  Spans nest by a stack: ``parent``
  is the span open around it, ``root`` the outermost one (one train
  step, one eval chunk).
* ``@spanned(name)`` puts a whole function in a span; off, the call
  reads the flag and goes straight on to the function.
* ``count(name, value, most=None)`` adds one value a call: a host int
  as it is, a tensor as the sum of its elements; the tensor is kept as
  it is (no device work, no sync) and summed and read in one transfer
  a device when ``recording()`` exits; ``most`` caps the value.  Off,
  it returns before it touches ``value``.
* ``on()`` says whether a record is open, for a site whose value costs
  work to compute.

One record at a time, fed from one thread (the one that launches the
work); the stages and the counters the program reports are named in
``PERF.md``.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, NamedTuple, Optional

import torch

_RECORD = None  # the open Record, or None: the tracer is off


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    root: int


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Record:
    """What one ``recording()`` received: ``spans`` in the order they
    ended, ``counts`` by name, each a list of one value a call."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, list] = {}
        self._open: List[int] = []  # ids of the spans open, outermost first
        self._next = 0
        self._tensors = []  # (list, index, tensor, most), read at close

    def count(self, name: str, value, most: Optional[int] = None):
        values = self.counts.setdefault(name, [])
        if isinstance(value, torch.Tensor):
            self._tensors.append((values, len(values), value.detach(), most))
            values.append(None)
        else:
            values.append(int(value) if most is None
                          else min(int(value), int(most)))

    def close(self):
        """Read the device counters: one stack and one transfer per
        device."""
        by_device: Dict[torch.device, list] = {}
        for entry in self._tensors:
            by_device.setdefault(entry[2].device, []).append(entry)
        for entries in by_device.values():
            sums = torch.stack([t.sum().to(torch.int64) if most is None
                                else t.sum().to(torch.int64).clamp(max=most)
                                for _, _, t, most in entries]).tolist()
            for (values, i, _, _), v in zip(entries, sums):
                values[i] = v
        self._tensors = []


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "root", "start")

    def __init__(self, rec: Record, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.id = rec._next
        rec._next += 1
        self.parent = rec._open[-1] if rec._open else None
        self.root = rec._open[0] if rec._open else self.id
        rec._open.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec._open.pop()
        rec.spans.append(Span(self.name, self.id, self.parent, self.start,
                              end, self.root))
        return False


def span(name: str):
    """A stage named ``name``: ``with trace.span("model.march"): ...``."""
    rec = _RECORD
    if rec is None:
        return NO_SPAN
    return _Span(rec, name)


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            rec = _RECORD
            if rec is None:
                return fn(*args, **kw)
            with _Span(rec, name):
                return fn(*args, **kw)
        return call
    return wrap


def count(name: str, value, most: Optional[int] = None):
    """Add ``value`` (a host int, or a tensor's sum, at most ``most``) to
    the counter ``name`` of the open record."""
    rec = _RECORD
    if rec is None:
        return
    rec.count(name, value, most)


def on() -> bool:
    return _RECORD is not None


@contextlib.contextmanager
def recording():
    """Turn the tracer on for the body; yields the ``Record``, whose
    device counters are read once the body has run."""
    global _RECORD
    if _RECORD is not None:
        raise RuntimeError("a trace is already recording")
    rec = Record()
    _RECORD = rec
    try:
        yield rec
    finally:
        _RECORD = None
    rec.close()
