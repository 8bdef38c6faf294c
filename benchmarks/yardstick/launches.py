"""Records the launches of the program's hand-written kernels (G1, K1,
K2) in a traced stretch: each call's shapes, and around it a host span
``benchmark.<kernel>`` that ties the kernel's device time to it through
the profiler's correlation ids (``attributed_seconds``), whatever the
kernel is named.

The recorder wraps the program's three entry points wherever a module
of the program holds them, and puts them back on exit.  It keeps a
copy of each gather's indices, up to ``keep_bytes``, to count the
distinct table rows after the stretch; a launch past that takes the
distinct share of the last kept launch of the same shape, or none.
"""

from __future__ import annotations

import functools
import sys
from typing import Dict, List

import torch

from . import roofline

PROGRAM = "rise_sdf_tpu_torch"
ENTRIES = {"g1": ("rise_sdf_tpu_torch.ops.gather", "gather_rows"),
           "k1": ("rise_sdf_tpu_torch.ops.scatter", "scatter_add"),
           "k2": ("rise_sdf_tpu_torch.ops.scatter_sorted",
                  "scatter_add_sorted")}
SPAN = "benchmark.{}"


class LaunchRecorder:
    def __init__(self, keep_bytes: int = 8 << 30):
        self.keep_bytes = keep_bytes
        self.kept = 0
        self.records: Dict[str, List[dict]] = {k: [] for k in ENTRIES}
        self._patched = []

    def _record(self, kind, args, kw):
        if kind == "g1":
            table, idx = args[0], args[1]
            rec = {"rows": idx.numel(), "table_rows": table.shape[0],
                   "row_bytes": table.shape[1] * table.element_size()}
            nbytes = idx.numel() * idx.element_size()
            if self.kept + nbytes <= self.keep_bytes:
                rec["idx"] = idx.detach().clone()
                self.kept += nbytes
        else:
            idx, vals = args[0], args[1]
            table = args[2] if len(args) > 2 else kw["table_size"]
            rec = {"rows": idx.numel(), "features": vals.shape[1],
                   "value_bytes": vals.element_size(),
                   "table_rows": int(table)}
        self.records[kind].append(rec)

    def _wrap(self, kind, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            with torch.profiler.record_function(SPAN.format(kind)):
                out = fn(*args, **kw)
            self._record(kind, args, kw)
            return out
        return wrapper

    def __enter__(self):
        for kind, (mod_name, attr) in ENTRIES.items():
            mod = sys.modules.get(mod_name)
            if mod is None:
                continue
            orig = getattr(mod, attr)
            wrapper = self._wrap(kind, orig)
            for name, m in list(sys.modules.items()):
                if m is None or name.split(".")[0] != PROGRAM:
                    continue
                for key, val in list(vars(m).items()):
                    if val is orig:
                        setattr(m, key, wrapper)
                        self._patched.append((m, key, orig, wrapper))
        return self

    def __exit__(self, *exc):
        for m, key, orig, wrapper in reversed(self._patched):
            setattr(m, key, orig)
            # the program's counters (``fn.launches``) counted on the
            # wrapper while it stood in the function's own module
            for k, v in vars(wrapper).items():
                if k != "__wrapped__" and isinstance(v, int):
                    setattr(orig, k, v)
        self._patched = []
        return False

    def bytes_of(self, kind: str) -> int:
        """The byte bound's bytes of every launch of ``kind`` recorded."""
        total, ratio = 0, {}
        for r in self.records[kind]:
            if kind != "g1":
                total += roofline.scatter_bytes(
                    r["rows"], r["features"], r["table_rows"],
                    r["value_bytes"])
                continue
            shape = (r["rows"], r["table_rows"], r["row_bytes"])
            if "idx" in r:
                idx = r.pop("idx")
                distinct = int(torch.unique(idx[idx >= 0]).numel())
                ratio[shape] = distinct / max(r["rows"], 1)
                r["distinct"] = distinct
            else:
                r["distinct"] = int(ratio.get(shape, 0.0) * r["rows"])
            total += roofline.gather_bytes(r["rows"], r["row_bytes"],
                                           r["distinct"])
        return total
