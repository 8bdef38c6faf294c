"""Runs one cell of the benchmark once and prints its result line.

    python3 -m benchmarks.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

It loads the cell (``cells.py``), sets up the program with the seed's
weights and inputs, measures for ``--seconds`` and checks what the timed
path produced against the plain reference (``reference/``).  The last
line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also close standard error.  Without CUDA, or with fewer cards than
the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it exits 1 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rise_sdf_tpu")
NAME_CHARS = 160  # of an operation's name in the breakdown
CACHE = Path(__file__).resolve().parent / "_cache"


def _environment(traffic: dict):
    """Build and kernel caches at fixed paths inside the checkout, one
    host thread for torch's CPU operations (the window only launches
    work on the card; idle pool threads take cores from the one that
    launches), and what the deterministic mode needs before CUDA
    starts."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    if traffic.get("deterministic", False):
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", root=None, log=None) -> dict:
    """One run of ``workload``; returns the result line as a dict.  The
    look for a card is ``main``'s, so tests drive this on the CPU."""
    from . import cells, common, render, train
    from .yardstick import compare, launches, trace

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    kw = {} if root is None else {"root": Path(root),
                                  "here": Path(root) / "benchmarks"}
    cell = cells.load(workload, **kw)
    _environment(cell.traffic)
    import torch

    torch.set_num_threads(1)
    mix = {"train": train, "render": render}[cell.traffic["kind"]]
    res = mix.run(cell, int(seed), float(seconds), traced, device,
                  common.Clock(T0), log)
    numbers = res["numbers"]
    correct = compare.judge(numbers, cell.limits)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not traced:
        # setup_s, and the mix's rate under each metric of its unit
        values = {"setup_s": res["setup_s"]}
        for m in cell.end_to_end:
            v = values.get(m["name"], res["rate"] if m["unit"] ==
                           res["rate_unit"] else None)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": torch.cuda.get_device_name(0)
           if torch.device(device).type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": res["memory_peak"]}
    if traced:
        t = res["trace"]
        reduced = trace.reduce(t["device_events"])
        t["reduced"] = reduced
        t["kernel_seconds"] = {
            k: trace.attributed_seconds(t["events"],
                                        launches.SPAN.format(k))
            for k in launches.ENTRIES}
        for name, read in cell.readers.items():
            v = read(t)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        out["breakdown"] = {k: [[name[:NAME_CHARS], v]
                                for name, v in reduced[k]]
                            for k in ("device_ops", "idle_gaps")}
    out["device"] = dev
    checks = compare.report(numbers, cell.limits)
    out["checks"] = {k: {"value": _finite(v["value"]),
                         "limit": v["limit"]} for k, v in checks.items()}
    for k, v in checks.items():
        log(f"check {k}: {v['value']!r} limit {v['limit']!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import cells

    cell = cells.load(args.workload)
    _environment(cell.traffic)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 1
    scratch = tempfile.mkdtemp(prefix="benchmark-run-")
    tempfile.tempdir = scratch
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    finally:
        tempfile.tempdir = None
        shutil.rmtree(scratch, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of {found} are loaded", file=sys.stderr)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
