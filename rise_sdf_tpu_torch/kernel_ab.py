"""Same-call A/B of the kernels K1 and G1 against another tree's, on one
NVIDIA GPU.

    python3 chip_smoke.py --save-streams _ab/streams.pt
    python3 -m rise_sdf_tpu_torch.kernel_ab --parent _ab/parent \\
        [--streams _ab/streams.pt] [--out ab.json] [--steps 120]
        [--kernels-only]

``--parent`` holds an unpacked copy of another commit of this repository
(``git archive <commit> | tar -x -C _ab/parent``; ``_ab/`` is
gitignored); this tree is the change.  The parent's K1 must take the
``period`` argument and its package must hold ``measure.py``; an older
commit's copy needs both patched in first.  Both trees'
``csrc/scatter_add.cu`` and ``csrc/gather_rows.cu`` are built (each tree
with its own ``ops/cuda_build.py``, all at once) and loaded side by side
with ``ctypes``.  In the order parent, change, change, parent the script
then times:

1. the kernels, on the same inputs for both sides: K1 and G1 at the
   uniform shapes of ``chip_smoke.py`` (``measure.k1_shapes`` and
   ``measure.g1_shapes``); and, with ``--streams``, both on each
   recorded stream that the file holds (``chip_smoke.py`` saves them
   all): K1 and G1 on the step-1 training stream, G1 on the render
   chunk's band-sample encode and on its baked-SDF reads (the bake
   stream: the visibility probe's and the secondary alpha's rows of the
   129^3 x 8 table, G1's 16-byte path).  Each time is the median of 10
   CUDA-event samples of 10 back-to-back calls
   (``measure.median_ms``), beside ``index_add_`` / ``index_select`` on
   the same inputs; every side's result is held to the float64
   reference (K1) or to ``index_select`` bit for bit (G1) first; G1 is
   also timed inside a CUDA graph of 10 launches into one output
   (``graph_ms``), its device time alone, where a small gather would
   otherwise wait on the host between launches, beside a copy of as many
   bytes as its output (``copy_ms``: the card's copy rate, which a
   gather of wide rows from a table larger than L2 cannot beat);
2. end to end (unless ``--kernels-only``), each in a process of its
   own in that side's tree: the
   800x800 render (``python -m rise_sdf_tpu_torch.bench
   --profile-chunks 8``) and ``--steps`` steps of the NeuS slice at
   ``neus_sphere_full`` (``python -m rise_sdf_tpu_torch.measure``).

It prints a table and, last, one JSON line with every number; ``--out``
writes the same JSON to a file.  Only ratios taken inside one run
compare: two runs may land on two cards.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .measure import g1_shapes, k1_shapes, median_ms

REPO = Path(__file__).resolve().parent.parent

_BUILD = (
    "from rise_sdf_tpu_torch.ops import cuda_build as c\n"
    "names = ['scatter_add', 'gather_rows']\n"
    "c.build_libraries(names)\n"
    "print(*(c._so_path(n) for n in names))\n")


class Side:
    """One tree's K1 and G1, loaded with ``ctypes``; launches on the
    current stream, as the port's wrappers do."""

    def __init__(self, tree: Path, sos):
        self.tree = tree
        k1, g1 = (ctypes.CDLL(str(so)) for so in sos)
        k1.rise_scatter_add_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p]
        k1.rise_scatter_add_f32.restype = ctypes.c_int
        g1.rise_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p]
        g1.rise_gather_rows.restype = ctypes.c_int
        self.k1, self.g1 = k1.rise_scatter_add_f32, g1.rise_gather_rows

    def scatter(self, idx, vals, t, period):
        out = torch.zeros((t, vals.shape[1]), device="cuda")
        rc = self.k1(idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                     idx.numel(), vals.shape[1], t, period,
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.tree}: K1 launch failed ({rc})")
        return out

    def gather(self, table, idx, out=None):
        if out is None:
            out = torch.empty((idx.numel(), table.shape[1]),
                              dtype=table.dtype, device="cuda")
        rc = self.g1(idx.data_ptr(), table.data_ptr(), out.data_ptr(),
                     idx.numel(), table.shape[1] * table.element_size(),
                     table.shape[0], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.tree}: G1 launch failed ({rc})")
        return out


def build(trees):
    """Both trees' kernels, each built by its own ``cuda_build``, all at
    once; returns the libraries' paths per tree."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD], cwd=tree,
                              env=dict(os.environ, PYTHONPATH=str(tree)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for tree in trees]
    sos = []
    for tree, proc in zip(trees, procs):
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"building {tree}'s kernels failed:\n{out}")
        sos.append(out.split()[-2:])
    return sos


def stream_cases(path):
    """K1's and G1's cases on each recorded stream the file holds."""
    s = torch.load(path, map_location="cuda")
    k1, g1 = {}, {}
    if "train_rows" in s:
        rows = s["train_rows"]
        k1["train stream"] = (rows.reshape(-1), s["train_vals"],
                              s["train_table"].shape[0],
                              rows.shape[-2] * rows.shape[-1])
        g1["train stream"] = (s["train_table"], rows.reshape(-1))
    if "render_rows" in s:
        g1["render stream"] = (s["render_table"],
                               s["render_rows"].reshape(-1))
    for part in ("probe", "alpha"):
        if f"bake_{part}_rows" in s:
            g1[f"bake stream, {part}"] = (s["bake_table"],
                                          s[f"bake_{part}_rows"])
    return k1, g1


def graph_ms(fn, launches=10):
    """Device ms per call of ``fn``, from a CUDA graph of ``launches``
    calls replayed (median of ``measure.median_ms``'s samples): no host
    time between the launches, which a kernel of a few microseconds
    would otherwise wait on."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = median_ms(graph.replay) / launches
    del graph
    return ms


def check(sides, k1_cases, g1_cases):
    """Every side right on every input before it is timed."""
    for side in sides:
        for what, (idx, vals, t, p) in k1_cases.items():
            got = side.scatter(idx, vals, t, p).double()
            ref = torch.zeros_like(got).index_add_(0, idx.long(),
                                                   vals.double())
            s = torch.zeros_like(got).index_add_(0, idx.long(),
                                                 vals.double().abs())
            if not bool(((got - ref).abs() <= 1e-5 * s + 1e-7).all()):
                raise SystemExit(f"{side.tree}: K1 wrong at {what}")
        for what, (table, idx) in g1_cases.items():
            if not torch.equal(side.gather(table, idx).view(torch.int32),
                               table.index_select(0, idx.long()).view(
                                   torch.int32)):
                raise SystemExit(f"{side.tree}: G1 wrong at {what}")


def kernel_rounds(sides, k1_cases, g1_cases):
    """Every side twice, in the order parent, change, change, parent; the
    library call in every round."""
    order = ["parent", "change", "change", "parent"]
    res = {f"K1 {k}": {n: [] for n in sides} for k in k1_cases}
    res.update({f"G1 {k}": {n: [] for n in sides} for k in g1_cases})
    lib = {k: [] for k in res}
    graphed = {f"G1 {k}": {n: [] for n in sides} for k in g1_cases}
    for name in order:
        side = sides[name]
        for what, (idx, vals, t, p) in k1_cases.items():
            res[f"K1 {what}"][name].append(median_ms(
                lambda: side.scatter(idx, vals, t, p)))
            lib[f"K1 {what}"].append(median_ms(lambda: torch.zeros(
                (t, 2), device="cuda").index_add_(0, idx, vals)))
        for what, (table, idx) in g1_cases.items():
            res[f"G1 {what}"][name].append(median_ms(
                lambda: side.gather(table, idx)))
            lib[f"G1 {what}"].append(median_ms(
                lambda: torch.index_select(table, 0, idx)))
            out = torch.empty((idx.numel(), table.shape[1]),
                              dtype=table.dtype, device="cuda")
            graphed[f"G1 {what}"][name].append(graph_ms(
                lambda: side.gather(table, idx, out)))
            del out
            torch.cuda.empty_cache()
    # the card's copy rate at each gather's output size: a copy reads and
    # writes the output's bytes, a gather writes them and reads the rows
    copy = {}
    for what, (table, idx) in g1_cases.items():
        dst = torch.empty((idx.numel(), table.shape[1]), dtype=table.dtype,
                          device="cuda")
        src = torch.empty_like(dst)
        copy[f"G1 {what}"] = graph_ms(lambda: dst.copy_(src))
        del dst, src
        torch.cuda.empty_cache()
    out = {}
    for k, ms in res.items():
        ratio = sum(ms["change"]) / sum(ms["parent"])
        out[k] = {"ms": ms, "library_ms": lib[k], "change_over_parent": ratio,
                  "change_over_library": sum(ms["change"]) / 2
                  / float(np.median(lib[k]))}
        line = (f"{k:40s} library {float(np.median(lib[k])):.4f} ms; parent "
                f"{ms['parent'][0]:.4f} {ms['parent'][1]:.4f}; change "
                f"{ms['change'][0]:.4f} {ms['change'][1]:.4f} ({ratio:.3f})")
        if k in graphed:
            g = graphed[k]
            out[k]["graph_ms"] = g
            out[k]["graph_change_over_parent"] = \
                sum(g["change"]) / sum(g["parent"])
            out[k]["copy_ms"] = copy[k]
            line += (f"; in a graph: parent {g['parent'][0]:.4f} "
                     f"{g['parent'][1]:.4f}, change {g['change'][0]:.4f} "
                     f"{g['change'][1]:.4f} "
                     f"({out[k]['graph_change_over_parent']:.3f}); a copy "
                     f"of the output's bytes {copy[k]:.4f}")
        print(line, flush=True)
    return out


def run_json(cmd, tree, timeout):
    res = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(tree)),
                         timeout=timeout)
    if res.returncode:
        raise RuntimeError(f"{' '.join(cmd[:3])} in {tree} failed (exit "
                           f"{res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def end_to_end(trees, steps):
    runs = []
    for name in ("parent", "change", "change", "parent"):
        tree = trees[name]
        render = run_json([sys.executable, "-m", "rise_sdf_tpu_torch.bench",
                           "--profile-chunks", "8"], tree, 900)
        neus = run_json([sys.executable, "-m", "rise_sdf_tpu_torch.measure",
                         "--steps", str(steps)], tree, 900)
        row = {"side": name,
               "render_device_ms_per_8_chunks": render["profile_device_ms"],
               "render_g1_ms_per_8_chunks": render["g1_device_ms"],
               # G1's 16-byte path (the bake's reads); trees older than
               # its count leave it out
               "render_g1_16_ms_per_8_chunks": render.get("g1_16_device_ms"),
               "render_rays_per_s": render["rays_per_s"],
               "render_dropped_rays": render["dropped_rays"],
               "render_busy_share": render["device_busy_share"],
               **{f"neus_{k}": v for k, v in neus.items() if k != "top"}}
        runs.append(row)
        print(f"{name}: render {row['render_device_ms_per_8_chunks']:.2f} ms "
              f"of device time per 8 chunks (G1 "
              f"{row['render_g1_ms_per_8_chunks']:.3f}), "
              f"{row['render_rays_per_s']:.0f} rays/s, "
              f"{row['render_dropped_rays']} dropped; NeuS "
              f"{row['neus_steps_per_s']:.3f} steps/s, PSNR "
              f"{row['neus_psnr']:.3f} dB, per step: device "
              f"{row['neus_device_ms']:.2f} ms, K1 {row['neus_k1_ms']:.3f} ms "
              f"x {row['neus_k1_launches']:g}, G1 {row['neus_g1_ms']:.3f} ms "
              f"x {row['neus_g1_launches']:g}", flush=True)
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--streams", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels only, not the end-to-end runs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = {"parent": args.parent.resolve(), "change": REPO}
    sides = {name: Side(trees[name], so) for name, so in zip(
        trees, build(list(trees.values())))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_cases, g1_cases = dict(k1_shapes(gen)), dict(g1_shapes(gen))
    if args.streams:
        sk1, sg1 = stream_cases(args.streams)
        k1_cases.update(sk1)
        g1_cases.update(sg1)
    check(sides.values(), k1_cases, g1_cases)
    result = {"card": card,
              "kernels": kernel_rounds(sides, k1_cases, g1_cases)}
    del k1_cases, g1_cases
    torch.cuda.empty_cache()
    if not args.kernels_only:
        result["end_to_end"] = end_to_end(trees, args.steps)
    line = json.dumps(result)
    if args.out:
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
