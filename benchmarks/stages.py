"""A traced stretch with the program's own tracer on: the stages'
spans and counters (``rise_sdf_tpu_torch.trace``) over one sweep period
of training steps or one eval image, laid over a profile of the card's
work and the CUDA runtime calls (``common.traced_stretch`` without the
host's operations), for the readers of ``yardstick/spans.py``.

A mix keeps the record under the traced record's ``program`` key, after
its other stretches, which run with the tracer off::

    t["program"] = stages.train_period(trainer, dims, cfg, device, period)
    t["program"] = stages.image(renderer, device)

The record: ``events`` (``trace.Event`` tuples), ``spans``, ``counts``,
``periods`` (sweep periods or images) and ``model_flops``
(``yardstick/flops.py`` at the counted samples and rays of each
forward).  The stretch adds no sync to the body's: its length is the
trace's (``spans.window_s``).
"""

from __future__ import annotations

import torch

from . import common
from .yardstick import flops


def stretch(device, body, periods: int = 1) -> dict:
    """``body`` traced with the tracer on; its device counters are read
    once the profiler has stopped."""
    from rise_sdf_tpu_torch import trace

    with trace.recording() as rec:
        with common.traced_stretch(device, False) as dev:
            body()
    return {"events": dev["events"], "spans": [tuple(s) for s in rec.spans],
            "counts": rec.counts, "periods": periods}


def train_period(trainer, dims, cfg, device, period: int) -> dict:
    """``period`` steps of ``trainer`` from a sweep."""
    while not trainer.sweep_due():
        trainer.step()

    def body():
        for _ in range(period):
            trainer.step()

    rec = stretch(device, body)
    c = rec["counts"]
    rec["model_flops"] = sum(
        flops.train_step(dims, cfg, float(a), float(b))
        for a, b in zip(c.get("model.samples_kept", []),
                        c.get("model.rays_included", [])))
    return rec


def image(renderer, device) -> dict:
    """One image of ``renderer`` (``render.Renderer``): mips, bake and
    every chunk."""
    r = renderer

    def body():
        r.prepare_image()
        for j in range(len(r.starts)):
            r.chunk_out(j)

    with torch.no_grad():
        rec = stretch(device, body)
    c = rec["counts"]
    rec["model_flops"] = sum(
        flops.split_render_chunk(r.dims, float(a), float(v), float(m))
        for a, v, m in zip(c.get("model.samples_kept", []),
                           c.get("model.samples_shaded", []),
                           c.get("model.rays_included", [])))
    return rec
