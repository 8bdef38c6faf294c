"""Finds a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root lists the cells; a configuration is the file its entry names, a
traffic mix ``traffic/<traffic>.json``, a cell's correctness limits
``limits/<workload>.json`` and a per-layer metric's reader
``metrics/<metric>.py`` (a module with ``read(trace) -> float | None``).
A new cell, configuration, mix or metric is new files and entries."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def load_reader(path: Path) -> Callable:
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell: str, e2e: List[str]) -> bool:
    """A metric with ``workloads`` is the listed cells'; an end-to-end
    one without is every cell's, a per-layer one without is every cell's
    that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e


def load(workload: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload '{workload}' in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    readers = {m["name"]: load_reader(here / "metrics" / f"{m['name']}.py")
               for m in per_layer}
    return Cell(workload, int(w["chips"]), config, w["config"], traffic,
                limits, e2e, per_layer, readers)
