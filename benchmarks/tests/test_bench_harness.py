"""The harness on the CPU at the tiny sizes: the result line, finding a
cell's pieces by name, and what the run imports."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmarks import cells, run

from .tiny import REPO

SEED = 3_000_000_017  # above 32 signed bits, as a run's seed may be


def test_result_line_train(tiny_root):
    out = run.run_cell("neus-blender.train", SEED, 0.5, False,
                       device="cpu", root=tiny_root)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert out["metrics"]["train_steps_per_s"]["unit"] == "steps/s"
    assert out["metrics"]["setup_s"]["value"] > 0
    limits = json.loads((tiny_root / "benchmarks" / "limits"
                         / "neus-blender.train.json").read_text())
    assert set(out["checks"]) == set(limits)
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out, allow_nan=False)


def test_result_line_render_traced(tiny_root):
    out = run.run_cell("split-mixed-occ-tensoir.render", SEED, 0.5, True,
                       device="cpu", root=tiny_root)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "breakdown", "device", "checks"]
    assert out["correct"] is True
    # the per-layer metrics a CPU run can read; the kernels' rooflines
    # have no device time here and stay out of the line
    assert {"render_mfu_pct", "bake_mips_ms"} <= set(out["metrics"])
    assert "g1_roofline_pct.render" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0
    assert set(out["checks"]) == {"rgb_gap", "included_mismatch"}


def test_main_needs_a_card(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "neus-blender.train", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_every_cell_loads():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.config["run"]["name"]
        assert cell.readers and all(callable(r)
                                    for r in cell.readers.values())
        assert "setup_s" in [m["name"] for m in cell.end_to_end]


def test_new_pieces_are_found_by_name(tiny_root, tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as new
    files and entries, with no file of the benchmark edited."""
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    here = root / "benchmarks"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "neus-blender.json").read_text())
    (here / "configs" / "neus-other.json").write_text(json.dumps(cfg))
    tr = json.loads((here / "traffic" / "train.json").read_text())
    tr["warm_steps"] = 2
    (here / "traffic" / "train-short.json").write_text(json.dumps(tr))
    (here / "limits" / "neus-other.train-short.json").write_text(
        (here / "limits" / "neus-blender.train.json").read_text())
    (here / "metrics" / "steps_traced.py").write_text(
        "def read(t):\n    return float(len(t['spans']['occupancy']))\n")
    bench["configs"].append({"name": "neus-other", "source": "x",
                             "file": "benchmarks/configs/neus-other.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "neus-other.train-short",
                               "config": "neus-other",
                               "traffic": "train-short", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append("neus-other.train-short")
    bench["per_layer"].append({"name": "steps_traced", "unit": "1",
                               "better": "higher",
                               "source": "program_span", "layer": "trainer",
                               "moves": "train_steps_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load("neus-other.train-short", root=root, here=here)
    assert cell.traffic["warm_steps"] == 2
    assert "steps_traced" in cell.readers
    out = run.run_cell("neus-other.train-short", SEED, 0.3, True,
                       device="cpu", root=root)
    assert out["correct"] is True
    assert "steps_traced" in out["metrics"]


def _python(code, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_loads_no_jax(tiny_root):
    code = (
        "import sys\n"
        "from benchmarks import run\n"
        f"out = run.run_cell('split-mixed-occ-tensoir.train-s1-det', 5, 0.3,"
        f" True, device='cpu', root={str(tiny_root)!r})\n"
        "assert out['correct'], out\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'rise_sdf_tpu'}))\n")
    res = _python(code, REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    code = (
        "import importlib, pkgutil, sys\n"
        "import benchmarks.reference as r\n"
        "for m in pkgutil.walk_packages(r.__path__, r.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'rise_sdf_tpu',"
        " 'rise_sdf_tpu_torch'}))\n")
    res = _python(code, REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "[]"


def test_checkout_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    runs no cell and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    res = subprocess.run([sys.executable, "-m", "benchmarks.run",
                          "--workload", "neus-blender.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert res.stdout == ""
