"""Kernel timing and the training slices' rates on one NVIDIA GPU,
shared by ``chip_smoke.py`` and ``rise_sdf_tpu_torch.kernel_ab``.

    python -m rise_sdf_tpu_torch.measure [--preset neus|split|test]
                                         [--steps N]

``--preset neus`` (the default) trains ``neus_sphere_full`` (hash grid
16 x 2^19 x 2, 4096 rays x 1024 samples into a 1,048,576-sample buffer)
for ``--steps`` steps (120) and validates one view; it prints one JSON
line: steps/s over the last 60 steps, the validation PSNR, skipped
updates, and the device time per step with K1's and G1's share and
launches, from ``torch.profiler`` over steps 41-45.

``--preset split`` trains the flagship, ``split_mixed_occ_train_full``
(4096 rays, hybrid-FD normals, curvature probe, five bf16 heads, a 512^2
emitter) in two windows of ``--steps`` steps (32) from one fresh init
each: stage 0 from step 0 (6 hash levels open, no prefilter) and stage 1
from step ``SPLIT_STAGE1_STEP`` (all 16 open, the visibility prefilter,
the mips built in the loss, the secondary pass); then validates one
view.  Its JSON line: steps/s of each window over its last whole
occupancy-sweep periods (16 steps each, so one sweep per period is
timed) after the first 16 steps, K1's and G1's device ms and launches
per step from ``torch.profiler`` over stage-1 steps 13,010-13,014 (after
the window's first sweep at 13,008), peak device memory, PSNR, phys PSNR
and dropped rays.

``--preset test`` trains the flagship's stage-1 window (``--steps``, 32,
from a fresh init at ``SPLIT_STAGE1_STEP``), then runs the test protocol
(``SplitOccSystem.test``) on that state at ``split_mixed_occ_test_full``:
4 test views at 800x800 under the learned light and the ``warm`` and
``bright`` environments, one geometry pass per chunk for all three
(multi-emitter mode), then view 0 again in single-light mode (one render
per light).  Its JSON line: seconds per view of each mode (the whole
protocol, and its renders alone), the calibrated fractions, the rays
dropped after escalation, the metrics, G1's and K1's launches during
each run, the single-light run against the multi-emitter run's view 0
(the largest difference of each image and of the metrics), and device
ms per view by kernel (G1's among them) from ``torch.profiler`` over
view 1 of the multi-emitter run.

``--preset determinism`` checks and times torch's scan and
``index_add`` against ``volrend.blocked_cumsum`` and
``sorted_segment_sum`` on a 1,048,576-slot buffer (repeat differences,
median ms, and torch's two under ``torch.use_deterministic_algorithms``),
then trains the same stage-1 window and renders test view 0 of
``split_mixed_occ_test_full`` (the protocol of one view, calibration
included) in multi-emitter mode, twice each with the eval path's scan
and sum both plain (torch's ``cumsum`` and ``index_add`` in place of
``volrend``'s two), both deterministic, and one of them deterministic,
in mirrored order; then once in
single-light mode with both deterministic.  Its JSON line: each pair's
largest image difference and share of pixels more than 1e-4 apart, the
single-light images against the multi-emitter ones, the seconds per
view of each run and the ops' numbers.

Without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from .systems.neus import OCC_UPDATE_EVERY

LEVELS, LOG2_T = 16, 19
S1_ROWS = 12582912
# the profiled train steps: after PROFILE_FROM, outside the rate's window
PROFILE_FROM, PROFILE_STEPS = 40, 5
RATE_WINDOW = 60
# the flagship's stage-1 window starts here: every hash level open
# (6 + (13000 - 6000) / 500 = 20 >= 16), prefilter and split sum on
SPLIT_STAGE1_STEP = 13000
# the first stage-1 step after the window's first occupancy sweep (at
# 13008; the fresh all-occupied grid fits ~6 % of the rays before it):
# the profile covers the PROFILE_STEPS steps after it
SPLIT_PROFILE_FROM = SPLIT_STAGE1_STEP \
    + (-SPLIT_STAGE1_STEP) % OCC_UPDATE_EVERY + 1


def median_ms(fn, reps=10, inner=10):
    """Median over ``reps`` samples of the device time per call of
    ``fn``, each sample a run of ``inner`` back-to-back calls between two
    CUDA events, so the host's launch overhead overlaps the device's
    work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def main_path_rows(gen):
    """Level-l rows drawn from [0, min((res_l+1)^3, 2^19)) + l * 2^19, as
    the encode of 1,048,576 samples x 8 corners gives them, level-major;
    and the flattened table's size."""
    t = 2 ** LOG2_T
    return torch.cat([
        torch.randint(0, min((int(16 * 1.447269237440378 ** l) + 1) ** 3, t),
                      (8 * 1048576,), generator=gen, device="cuda",
                      dtype=torch.int32) + l * t
        for l in range(LEVELS)]), LEVELS * t


def k1_shapes(gen):
    """K1's uniform shapes, one at a time: ``(name, (idx, vals,
    table_size, period))``.  S1's (12,582,912 rows into one 2^19 x 2
    level) and the main path's (16 levels, walked with the period of the
    encode's ``[N, 16, 8]`` rows)."""
    t = 2 ** LOG2_T
    idx = torch.randint(0, t, (S1_ROWS,), generator=gen, device="cuda",
                        dtype=torch.int32)
    yield (f"S1 shape: {S1_ROWS} rows into {t} x 2",
           (idx, torch.randn((S1_ROWS, 2), generator=gen, device="cuda"), t,
            1))
    idx, t = main_path_rows(gen)
    yield (f"main path: {idx.numel()} rows into {t} x 2, P = 128",
           (idx, torch.randn((idx.numel(), 2), generator=gen, device="cuda"),
            t, 128))


def g1_shapes(gen):
    """G1's uniform shapes, one at a time: ``(name, (table, idx))``.
    S2/S3's, S4's (w = 2, 8, 32), one render chunk's (the hash encode,
    49,152 samples x 16 levels x 8 corners into 16 x 2^19 x 2; the
    baked-SDF probe, 4096 rays x 64 probes into 129^3 x 8) and the main
    path's."""
    t = 2 ** LOG2_T

    def uniform(n, w, m):
        table = torch.randn((n, w), generator=gen, device="cuda")
        return table, torch.randint(0, n, (m,), generator=gen, device="cuda",
                                    dtype=torch.int32)

    yield "S2/S3 shape", uniform(t, 2, 8388608)
    for w in (2, 8, 32):
        yield f"S4 shape, w={w}", uniform(t, w, 4194304)
    yield "render chunk, hash encode", uniform(LEVELS * t, 2, 49152 * 16 * 8)
    yield "render chunk, baked-SDF probe", uniform(129 ** 3, 8, 4096 * 64)
    idx, n = main_path_rows(gen)
    yield "main path", (torch.randn((n, 2), generator=gen, device="cuda"), idx)


class StepProfile:
    """``torch.profiler`` over train steps ``start + 1`` to ``start +
    PROFILE_STEPS``; call it from ``fit``'s ``on_log`` at every step."""

    def __init__(self, start=PROFILE_FROM):
        self.start = start
        self.prof, self.t0, self.wall_ms = None, 0.0, 0.0

    def __call__(self, step):
        if step == self.start:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif step == self.start + PROFILE_STEPS:
            torch.cuda.synchronize()
            self.wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.__exit__(None, None, None)

    def per_step(self):
        """Wall and device ms per step; K1's and G1's device ms and
        launches per step; the eight largest kernels as ``[name, ms per
        step, launches per step]``."""
        from .bench import _kernel_times

        times = _kernel_times(self.prof)
        n = PROFILE_STEPS
        out = {"steps": n, "wall_ms": self.wall_ms / n,
               "device_ms": sum(t for t, _ in times.values()) / n}
        for key, name in (("k1", "scatter_add"), ("g1", "gather_rows")):
            hits = [v for k, v in times.items() if name in k]
            out[f"{key}_ms"] = sum(t for t, _ in hits) / n
            out[f"{key}_launches"] = sum(c for _, c in hits) / n
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
        out["top"] = [[k[:90], t / n, c / n] for k, (t, c) in top]
        return out


def train(system, steps, seed, state, on_log=None, profile_from=PROFILE_FROM,
          window=RATE_WINDOW):
    """``system.fit`` for ``steps`` steps from ``state["step"]``, logging
    every step; a run past ``profile_from + PROFILE_STEPS`` profiles the
    steps after ``profile_from``.  Returns the state, the per-step
    metrics, steps/s over the last ``window`` steps (fewer in a short
    run) and ``StepProfile.per_step()`` (empty when the run is too
    short)."""
    stamps, metrics = [], []
    start = int(state["step"])
    prof = StepProfile(profile_from) \
        if start + steps > profile_from + PROFILE_STEPS else None

    def hook(step, m):
        stamps.append(time.perf_counter())
        metrics.append(m)
        if on_log is not None:
            on_log(step, m)
        if prof is not None:
            prof(step)

    state = system.fit(max_steps=start + steps, seed=seed, state=state,
                       log_every=1, on_log=hook)
    torch.cuda.synchronize()
    window = min(window, steps - 1)
    rate = window / (stamps[-1] - stamps[-1 - window])
    return state, metrics, rate, prof.per_step() if prof else {}


def train_split(system, steps, seed, on_log=None):
    """The flagship's two windows of ``steps`` steps (at least 32), each
    from a fresh init drawn from ``seed``: stage 0 from step 0, stage 1
    from ``SPLIT_STAGE1_STEP``, whose steps after ``SPLIT_PROFILE_FROM``
    are profiled.  Returns the stage-1 state, each window's metrics and
    steps/s, and the profile's ``per_step``.  A window's rate is taken
    over its last whole sweep periods after its first 16 steps (the
    warm-up; at stage 1 the profiled steps and the profiler's teardown,
    which lands on the step after them), so it counts one occupancy
    sweep every 16 steps, as a long run does."""
    period = OCC_UPDATE_EVERY
    first = max(period, SPLIT_PROFILE_FROM - SPLIT_STAGE1_STEP
                + PROFILE_STEPS + 1)
    if steps < first + period:
        raise ValueError(f"a flagship window needs at least "
                         f"{first + period} steps")
    window = (steps - first) // period * period
    out = {}
    for stage, start in ((0, 0), (1, SPLIT_STAGE1_STEP)):
        state = system.init_state(seed)
        state["step"] = start
        prof_from = SPLIT_PROFILE_FROM if stage else start + steps
        state, metrics, rate, per_step = train(
            system, steps, seed, state, on_log, profile_from=prof_from,
            window=window)
        out[stage] = (metrics, rate)
    return state, out, per_step


def test_system(trained, multi=True, n_images=None):
    """The split-occ system at ``split_mixed_occ_test_full`` (in
    multi-emitter mode or not, with ``n_images`` test views) with the
    parameters of the ``trained`` system."""
    from . import datasets, systems
    from .presets import split_mixed_occ_test_full

    cfg = split_mixed_occ_test_full()
    cfg["system"]["multi_emitter_eval"] = multi
    if n_images:
        cfg["dataset"]["n_images"] = n_images
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=os.path.join("exp", "test_protocol"),
                          device=trained.device)
    system.model.load_state_dict(trained.model.state_dict())
    return system


def run_test(system, state, profile_view=None, log=print):
    """``system.test`` timed on the card: the metrics (``dropped_rays``
    among them), the calibrated fractions, seconds per view of the whole
    protocol (metrics and image files included) and of its renders
    alone, G1's and K1's launches, the chunks rendered at each buffer
    size (1x, and 2x and 4x escalations), the rendered images, and with
    ``profile_view`` the device ms by kernel of that view's renders
    (``torch.profiler``, CUDA activity only: a view is some 10^5
    kernels) and their seconds under it, which the per-view rates leave
    out.  Logs each render's seconds."""
    from .bench import _kernel_times, _sync
    from .ops.gather import gather_rows
    from .ops.scatter import scatter_add

    render, images, times = system.render_image, [], {}
    seconds = {"render": 0.0, "profiled": 0.0}

    def timed(state_, split, index, **kw):
        _sync(system.device)
        t0 = time.perf_counter()
        if index != profile_view:
            out = render(state_, split, index, **kw)
        else:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                out = render(state_, split, index, **kw)
                _sync(system.device)
            for k, (t, c) in _kernel_times(prof).items():
                ms, n = times.get(k, (0.0, 0))
                times[k] = (ms + t, n + c)
        _sync(system.device)
        dt = time.perf_counter() - t0
        seconds["profiled" if index == profile_view else "render"] += dt
        what = "all lights" if kw.get("n_relights") else \
            "a relight light" if kw.get("relighting") else "learned light"
        log(f"    view {index}, {what}: {dt:.2f} s"
            + (" (profiled)" if index == profile_view else ""))
        images.append(out)
        return out

    chunk, chunks = system.render_chunk, {1: 0, 2: 0, 4: 0}

    def counted(state_, rays, mult=1, **kw):
        chunks[mult] += 1
        return chunk(state_, rays, mult, **kw)

    system.render_image, system.render_chunk = timed, counted
    g1, k1 = gather_rows.launches, scatter_add.launches
    _sync(system.device)
    t0 = time.perf_counter()
    try:
        metrics = system.test(state, export=False)
    finally:
        del system.render_image, system.render_chunk
    _sync(system.device)
    views = len(system.datamodule.test())
    timed_views = views - (profile_view is not None and profile_view < views)
    res = {"views": views,
           "s_per_view": (time.perf_counter() - t0 - seconds["profiled"])
           / timed_views,
           "render_s_per_view": seconds["render"] / timed_views,
           "fractions": dict(system.eval_fractions), "metrics": metrics,
           "g1_launches": gather_rows.launches - g1,
           "k1_launches": scatter_add.launches - k1,
           "chunks": {f"{m}x": n for m, n in chunks.items()},
           "images": images}
    if times:
        top = sorted(times.items(), key=lambda kv: -kv[1][0])
        res["profile"] = {
            "view": profile_view, "wall_s": seconds["profiled"],
            "device_ms": sum(t for t, _ in times.values()),
            "g1_ms": sum(t for k, (t, _) in times.items()
                         if "gather_rows" in k),
            "g1_launches": sum(c for k, (_, c) in times.items()
                               if "gather_rows" in k),
            "launches": sum(c for _, c in times.values()),
            "top": [[k[:80], t, c] for k, (t, c) in top[:8]]}
    return res


def test_protocol(trained, state, views=None, profile_view=None,
                  log=print):
    """The test protocol on ``state`` of the ``trained`` flagship: the
    preset's 4 views (or ``views``) in multi-emitter mode (with
    ``profile_view`` profiled), then view 0 in single-light mode.  The
    single-light run's images and metrics are held against the
    multi-emitter run's view 0: the largest difference of each image and
    the share of its pixels more than 1e-4 apart, and the largest
    difference of the metrics."""
    multi = run_test(test_system(trained, n_images=views), state,
                     profile_view=profile_view, log=log)
    log(f"  multi-emitter: {multi['s_per_view']:.2f} s/view "
        f"({multi['render_s_per_view']:.2f} s/view rendering)")
    single_system = test_system(trained, multi=False, n_images=1)
    single = run_test(single_system, state, log=log)
    view0 = multi["images"][0]
    names = ["comp_rgb_phys_full"] + [f"relight{j}/comp_rgb_phys_full"
                                      for j in range(len(
                                          single_system.relight_list))]
    # the single-light run renders view 0 once per light, in this order
    diffs = {name: np.abs(img["comp_rgb_phys_full"] - view0[name]).max(-1)
             for name, img in zip(names, single["images"])}
    single["max_abs_diff"] = {k: float(d.max()) for k, d in diffs.items()}
    single["share_above_1e-4"] = {k: float((d > 1e-4).mean())
                                  for k, d in diffs.items()}
    # view 0's metrics from the multi-emitter render (the one-view
    # split's camera is the four-view split's first)
    view0_metrics = single_system.view_metrics(
        single_system.datamodule.test(), 0, view0)
    single["max_metric_diff"] = max(
        abs(single["metrics"][k] - v) for k, v in view0_metrics.items())
    for run in (multi, single):
        del run["images"]
    return {"multi": multi, "single": single}


def _split_main(steps):
    from . import datasets, systems
    from .presets import split_mixed_occ_train_full

    cfg = split_mixed_occ_train_full()
    seed = int(cfg["seed"])
    save = os.path.join("exp", "measure")
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=save, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state, windows, per_step = train_split(system, steps, seed)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    val = system.validate(state, n_images=1)
    shutil.rmtree(save, ignore_errors=True)
    return {"stage0_steps_per_s": windows[0][1],
            "stage1_steps_per_s": windows[1][1],
            "peak_memory_gib": peak, "psnr": val["psnr"],
            "phys_psnr": val["phys_psnr"],
            "dropped_rays": val["dropped_rays"],
            "skipped": system.skipped_updates, **per_step}


def _test_main(steps):
    from . import datasets, systems
    from .presets import split_mixed_occ_train_full

    cfg = split_mixed_occ_train_full()
    seed = int(cfg["seed"])
    save = os.path.join("exp", "measure")
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=save, device="cuda")
    state = system.init_state(seed)
    state["step"] = SPLIT_STAGE1_STEP
    state, _, rate, _ = train(system, steps, seed, state,
                              profile_from=SPLIT_STAGE1_STEP + steps)
    res = test_protocol(system, state, profile_view=1,
                        log=lambda msg: print(msg, file=sys.stderr,
                                              flush=True))
    shutil.rmtree(save, ignore_errors=True)
    shutil.rmtree(os.path.join("exp", "test_protocol"), ignore_errors=True)
    return {"step": int(state["step"]), "stage1_steps_per_s": rate, **res}


def _image_diff(a, b):
    """The largest difference of two renders' images (every key of both)
    and the share of pixels more than 1e-4 apart, per key."""
    out = {}
    for k in a:
        if k in b and a[k].dtype.kind == "f" and a[k].ndim == 2:
            d = np.abs(a[k] - b[k]).max(-1)
            out[k] = {"max": float(d.max()),
                      "share_above_1e-4": float((d > 1e-4).mean())}
    return out


def _ops_repeat():
    """torch's scan and ``index_add`` against ``blocked_cumsum`` and
    ``sorted_segment_sum`` on a 1,048,576-slot ray-major buffer of 4096
    rays (the flagship's 4x eval buffer): the largest difference of two
    calls on the same input and the median ms of each; then torch's two
    under ``torch.use_deterministic_algorithms(True)``: the error they
    raise, or their repeat difference and ms."""
    from .ops import volrend

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_rays, c = 4096, 1 << 20
    counts = torch.randint(0, 2 * c // n_rays, (n_rays,), generator=gen,
                           device="cuda")
    ridx = torch.repeat_interleave(torch.arange(n_rays, device="cuda"),
                                   counts)[:c]
    ridx = torch.cat([ridx, torch.full((c - ridx.shape[0],), n_rays,
                                       device="cuda")])
    la = torch.log1p(-torch.rand(c, generator=gen, device="cuda") * 0.1)
    src = torch.rand((c, 30), generator=gen, device="cuda")

    def index_add():
        return src.new_zeros((n_rays + 1, 30)).index_add(0, ridx, src)[
            :n_rays]

    ops = {"cumsum": lambda: torch.cumsum(la, 0),
           "index_add_30": index_add,
           "blocked_cumsum": lambda: volrend.blocked_cumsum(la),
           "sorted_segment_sum_30": lambda: volrend.sorted_segment_sum(
               src, ridx, n_rays)}

    def run(fn):
        diff = max(float((fn() - fn()).abs().max()) for _ in range(5))
        return {"repeat_max_diff": diff, "ms": median_ms(fn)}

    res = {name: run(fn) for name, fn in ops.items()}
    torch.use_deterministic_algorithms(True)
    try:
        for name in ("cumsum", "index_add_30"):
            try:
                res[name + "_deterministic_mode"] = run(ops[name])
            except RuntimeError as e:
                res[name + "_deterministic_mode"] = {
                    "raises": str(e).splitlines()[0][:200]}
    finally:
        torch.use_deterministic_algorithms(False)
    return res


def _determinism_main(steps):
    from . import datasets, systems
    from .ops import volrend
    from .presets import split_mixed_occ_train_full

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    res = {"ops": _ops_repeat()}
    print(json.dumps(res), file=sys.stderr, flush=True)
    cfg = split_mixed_occ_train_full()
    seed = int(cfg["seed"])
    save = os.path.join("exp", "measure")
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=save, device="cuda")
    state = system.init_state(seed)
    state["step"] = SPLIT_STAGE1_STEP
    state, _, _, _ = train(system, steps, seed, state,
                           profile_from=SPLIT_STAGE1_STEP + steps)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731

    det = {"scan": ("blocked_cumsum", volrend.blocked_cumsum),
           "sum": ("sorted_segment_sum", volrend.sorted_segment_sum)}
    plain = {"scan": lambda x: torch.cumsum(x, 0),
             "sum": lambda src, ridx, n: src.new_zeros(
                 (n + 1, src.shape[1])).index_add(0, ridx, src)[:n]}

    def view0(ops, multi=True):
        # the ops not in ``ops`` run as torch's own on the eval path
        for op, (name, _) in det.items():
            if op not in ops:
                setattr(volrend, name, plain[op])
        try:
            run = run_test(test_system(system, multi=multi, n_images=1),
                           state, log=log)
        finally:
            for name, fn in det.values():
                setattr(volrend, name, fn)
        log(f"  view 0, deterministic {sorted(ops)}, multi {multi}: "
            f"{run['s_per_view']:.2f} s")
        return run

    order = [("plain", ()), ("both", ("scan", "sum")),
             ("scan", ("scan",)), ("sum", ("sum",)),
             ("sum", ("sum",)), ("scan", ("scan",)),
             ("both", ("scan", "sum")), ("plain", ())]
    runs = {}
    for name, ops in order:
        runs.setdefault(name, []).append(view0(ops))
    single = view0(("scan", "sum"), multi=False)
    res["seconds_per_view"] = {k: [r["s_per_view"] for r in v]
                               for k, v in runs.items()}
    res["same_mode_repeat"] = {
        k: _image_diff(v[0]["images"][0], v[1]["images"][0])
        for k, v in runs.items()}
    both = runs["both"][0]["images"][0]
    names = ["comp_rgb_phys_full"] + [
        f"relight{j}/comp_rgb_phys_full"
        for j in range(len(system.config["dataset"].get(
            "relight_list", []) or []))]
    res["single_vs_multi_both"] = {
        name: _image_diff({"x": o["comp_rgb_phys_full"]},
                          {"x": both[name]})["x"]
        for name, o in zip(names, single["images"])}
    res["single_seconds_per_view"] = single["s_per_view"]
    shutil.rmtree(save, ignore_errors=True)
    shutil.rmtree(os.path.join("exp", "test_protocol"), ignore_errors=True)
    return {"step": int(state["step"]), **res}


def main(argv=None):
    from . import datasets, systems
    from .presets import neus_sphere_full

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=("neus", "split", "test",
                                         "determinism"),
                    default="neus")
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.preset == "split":
        res = _split_main(args.steps or 32)
    elif args.preset == "test":
        res = _test_main(args.steps or 32)
    elif args.preset == "determinism":
        res = _determinism_main(args.steps or 32)
    else:
        cfg = neus_sphere_full()
        seed = int(cfg.get("seed", 42))
        save = os.path.join("exp", "measure")
        system = systems.make(cfg["system"]["name"], cfg,
                              datasets.make(cfg["dataset"]["name"],
                                            cfg["dataset"]),
                              save_dir=save, device="cuda")
        state, _, rate, per_step = train(system, args.steps or 120, seed,
                                         system.init_state(seed))
        psnr = float(system.validate(state, n_images=1)["psnr"])
        shutil.rmtree(save, ignore_errors=True)
        res = {"steps_per_s": rate, "psnr": psnr,
               "skipped": system.skipped_updates, **per_step}
    res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
