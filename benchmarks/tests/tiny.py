"""A copy of the benchmark's data at the port's tiny sizes, for the CPU
tests: the same cells, metrics and limits, with the tiny presets as
configurations and traffic scaled to them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TRAFFIC = {
    "train": {"kind": "train", "start_step": 0, "warm_steps": 4,
              "compared_steps": 3, "occupancy_every": 16},
    # the tiny flagship's split sum starts at step 10; a run starts on a
    # sweep, as the full one does
    "train-s1": {"kind": "train", "start_step": 16, "warm_steps": 4,
                 "compared_steps": 3, "occupancy_every": 16},
    "train-s1-det": {"kind": "train", "start_step": 16, "warm_steps": 4,
                     "compared_steps": 3, "occupancy_every": 16,
                     "deterministic": True},
    "render": {"kind": "render", "image_wh": 16, "eye": [0.0, -4.0, 0.0],
               "fov": 0.35, "variance": 0.67, "model": {},
               "compared_chunks": 1},
}


def configs():
    from rise_sdf_tpu_torch import presets
    from rise_sdf_tpu_torch.bench import tiny_bench_config

    return {"neus-blender": presets.tiny_neus_config(),
            "split-mixed-occ-tensoir": presets.tiny_split_config(),
            "split-bench": tiny_bench_config()}


def make(root: Path) -> Path:
    """Write the tiny benchmark under ``root``; returns ``root``."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    here = root / "benchmarks"
    for d in ("traffic", "limits", "metrics"):
        shutil.copytree(REPO / "benchmarks" / d, here / d,
                        dirs_exist_ok=True)
    (here / "configs").mkdir(parents=True, exist_ok=True)
    bench["configs"].append({
        "name": "split-bench", "source": "tiny_bench_config",
        "file": "benchmarks/configs/split-bench.json", "reduced": [],
        "why": "the tiny flagship with the eval options of the bench"})
    for name, cfg in configs().items():
        (here / "configs" / f"{name}.json").write_text(
            json.dumps({"run": cfg}))
    for c in bench["configs"]:
        c["file"] = f"benchmarks/configs/{c['name']}.json"
    for w in bench["workloads"]:
        if w["traffic"] == "render":
            w["config"] = "split-bench"
    # the flagship's deterministic training, whose traffic and limits the
    # benchmark keeps for a later cell (its runs spread too far on the
    # card's shared host to hold a bound yet)
    det = "split-mixed-occ-tensoir.train-s1-det"
    bench["workloads"].append({
        "name": det, "config": "split-mixed-occ-tensoir",
        "traffic": "train-s1-det", "chips": 1, "why": "tests"})
    bench["end_to_end"].append({
        "name": "train_steps_per_s.det", "unit": "steps/s",
        "better": "higher", "bound": 0.25, "source": "host_clock",
        "workloads": [det]})
    bench["per_layer"].append({
        "name": "k2_roofline_pct", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "kernels",
        "moves": "train_steps_per_s.det", "workloads": [det]})
    for name, tr in TRAFFIC.items():
        (here / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
