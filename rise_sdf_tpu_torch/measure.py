"""Kernel timing and the training slices' rates on one NVIDIA GPU,
shared by ``chip_smoke.py`` and ``rise_sdf_tpu_torch.kernel_ab``.

    python -m rise_sdf_tpu_torch.measure [--preset neus|split|test|
                                          determinism|ddp|pbr]
                                         [--steps N] [--views N]
                                         [--table-shards N]

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
ms per view by kernel (G1's among them, and its 16-byte path's,
``g1_16_ms``) from ``torch.profiler`` over view 1 of the multi-emitter
run.  ``--views N`` renders N test views (at least 2: view 1 is
profiled) in place of 4.

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

``--preset pbr`` measures the spread of ``chip_smoke.py`` phase 15b's
``volume-pbr`` shading on a freshly trained stage-1 state: card runs
against each other (default mode and deterministic) and every chunk of
test view 0 against the CPU, which shades it once from its own sampled
directions and once from the card's (``_pbr_main``).

``--preset ddp`` runs the flagship's data-parallel window
(``ddp_window``): a fresh init at stage 1 for ``--steps`` steps (16)
over NCCL ranks, one per GPU (up to 4), or over two gloo ranks sharing
the one card there is; then one validation view sharded over the ranks.
``--table-shards N`` splits every hash table's rows over N ranks of
each data index (``system.table_shards``; N divides the ranks).
Its JSON line holds each rank's report: steps/s, K1's and G1's launches
per step, peak memory, the all-reduce's ms and MB per step, the
all-reduced gradient against the ranks' float64 mean, and whether the
ranks' params are bit-equal; with table shards also the MB per step of
the gradient all-reduces over the world (``allreduce_mb_world``) and
over the data group (``allreduce_mb_data``), and of the encodes'
feature all-reduces over the model group (``allreduce_mb_model``).

Without CUDA it raises.
"""

from __future__ import annotations

import argparse
import contextlib
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
    S2/S3's, S4's (w = 2, 8, 32, and float64 W = 2: rows of one 16-byte
    vector), one render chunk's (the hash encode, 49,152 samples x 16
    levels x 8 corners into 16 x 2^19 x 2; the
    baked-SDF probe, 4096 rays x 64 probes into 129^3 x 8) and the main
    path's."""
    t = 2 ** LOG2_T

    def uniform(n, w, m, dtype=torch.float32):
        table = torch.randn((n, w), generator=gen, device="cuda",
                            dtype=dtype)
        return table, torch.randint(0, n, (m,), generator=gen, device="cuda",
                                    dtype=torch.int32)

    yield "S2/S3 shape", uniform(t, 2, 8388608)
    for w in (2, 8, 32):
        yield f"S4 shape, w={w}", uniform(t, w, 4194304)
    yield "S4 shape, float64 W=2", uniform(t, 2, 4194304, torch.float64)
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


def test_system(trained, multi=True, n_images=None, model=None,
                relights=None, img_wh=None):
    """The split-occ system at ``split_mixed_occ_test_full`` (in
    multi-emitter mode or not, with ``n_images`` test views, the
    ``model`` keys over the preset's, the ``relights`` lights in place
    of the preset's ``warm`` and ``bright``, the views at ``img_wh`` in
    place of 800 x 800) with the parameters of the ``trained``
    system."""
    from . import datasets, systems
    from .presets import split_mixed_occ_test_full

    cfg = split_mixed_occ_test_full()
    cfg["system"]["multi_emitter_eval"] = multi
    cfg["model"].update(model or {})
    if n_images:
        cfg["dataset"]["n_images"] = n_images
    if relights is not None:
        cfg["dataset"]["relight_list"] = list(relights)
    if img_wh is not None:
        cfg["dataset"]["img_wh"] = list(img_wh)
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
    alone, G1's and K1's launches (``g1_16_launches``: G1's on its
    16-byte path, the baked-SDF sample), the chunks rendered at each
    buffer size (1x, and 2x and 4x escalations), the rendered images,
    and with
    ``profile_view`` the device ms by kernel of that view's renders
    (``torch.profiler``, CUDA activity only: a view is some 10^5
    kernels) and their seconds under it, which the per-view rates leave
    out; ``residual_rays``, the rays that surface chunks sent to the
    volumetric residual (0 in volume mode).  Logs each render's
    seconds."""
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
    g16 = gather_rows.launches16
    residual = system.residual_rays
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
           "g1_16_launches": gather_rows.launches16 - g16,
           "k1_launches": scatter_add.launches - k1,
           "chunks": {f"{m}x": n for m, n in chunks.items()},
           "residual_rays": system.residual_rays - residual,
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
            "g1_16_ms": sum(t for k, (t, _) in times.items()
                            if "gather_rows16" in k),
            "g1_16_launches": sum(c for k, (_, c) in times.items()
                                  if "gather_rows16" in k),
            "launches": sum(c for _, c in times.values()),
            "top": [[k[:80], t, c] for k, (t, c) in top[:8]]}
    return res


def test_protocol(trained, state, views=None, profile_view=None,
                  log=print, model=None, relights=None, img_wh=None):
    """The test protocol on ``state`` of the ``trained`` flagship (with
    the ``model`` keys over the preset's, the ``relights`` lights and
    the ``img_wh`` view size when given): the preset's 4 views (or
    ``views``) in multi-emitter mode (with ``profile_view`` profiled),
    then view 0 in single-light mode.  The
    single-light run's images and metrics are held against the
    multi-emitter run's view 0: the largest difference of each image and
    the share of its pixels more than 1e-4 apart, and the largest
    difference of the metrics.  ``view0_pair`` is view 0's phys render
    and its ground truth, [H, W, 3] each (LPIPS' input);
    ``view0_surface`` its rays [H * W, 6] in pixel order, ``depth`` [H *
    W, 1] and ``normal`` [H * W, 3] (host arrays)."""
    multi = run_test(test_system(trained, n_images=views, model=model,
                                 relights=relights, img_wh=img_wh),
                     state, profile_view=profile_view, log=log)
    log(f"  multi-emitter: {multi['s_per_view']:.2f} s/view "
        f"({multi['render_s_per_view']:.2f} s/view rendering)")
    single_system = test_system(trained, multi=False, n_images=1,
                                model=model, relights=relights,
                                img_wh=img_wh)
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
    split = single_system.datamodule.test()
    shape = (split.h, split.w, 3)
    pair = (view0["comp_rgb_phys_full"].reshape(shape),
            single_system._gt(split, 0)[0].reshape(shape))
    rays, inv = single_system.view_rays(split, 0)
    surface = {"rays": (rays if inv is None else rays[inv]).cpu().numpy(),
               "depth": view0["depth"], "normal": view0["comp_normal"]}
    return {"multi": multi, "single": single, "view0_pair": pair,
            "view0_surface": surface}


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


def _test_main(steps, views=None):
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
    res = test_protocol(system, state, views=views, profile_view=1,
                        log=lambda msg: print(msg, file=sys.stderr,
                                              flush=True))
    del res["view0_pair"], res["view0_surface"]
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


PBR_SEED, PBR_CHUNK = 15, 64000  # chip_smoke.py phase 15b's


@contextlib.contextmanager
def fixed_directions(scatterer, dirs):
    """Inside the block ``scatterer.sample_from_uniforms`` returns
    ``dirs`` [N, 3] (on the device of its ``n`` argument, which must be
    [N, 3]) in place of the directions it would sample: ``VolumePBR``
    then shades from ``dirs``.  Phase 15b shades on the CPU from the
    card's directions this way, so that card and CPU are compared on
    the same input."""
    def sample(u_spec, u_diff, u_pick, n, wi, alpha_x):
        if n.shape != dirs.shape:
            raise ValueError(f"fixed directions {tuple(dirs.shape)} for "
                             f"normals {tuple(n.shape)}")
        return dirs.to(n.device)

    scatterer.sample_from_uniforms = sample
    try:
        yield
    finally:
        del scatterer.sample_from_uniforms


def _pbr_main(steps):
    """``--preset pbr``: the spread of ``chip_smoke.py`` phase 15b's
    ``volume-pbr`` shading, card against card and card against CPU.  The
    flagship trained ``steps`` stage-1 steps from a fresh init, test
    view 0 of ``split_mixed_occ_test_full`` rendered for the shading
    points (rays, depth, normals), materials and uniforms drawn as 15b
    draws them; the shading of all ``PBR_CHUNK`` chunks three times in
    the default mode and twice under ``torch.use_deterministic_
    algorithms(True)``, then every chunk on the CPU, from its own
    directions and from the card's (``fixed_directions``).  Returns per
    output (transmittance ``tr``, secondary head ``sec``, ``dirs``,
    ``rgb_phys`` ...) the largest difference between card runs, and per
    chunk the largest |card - CPU| / max(1, max |CPU|) and the worst
    point's values on both, from the CPU's own directions (``chunks``,
    ``worst``) and from the card's (``chunks_same_dirs``,
    ``worst_same_dirs``)."""
    from . import datasets, models, systems
    from .presets import split_mixed_occ_train_full

    cfg = split_mixed_occ_train_full()
    save = os.path.join("exp", "measure_pbr")
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=save, device="cuda")
    state = system.init_state(int(cfg["seed"]))
    state["step"] = SPLIT_STAGE1_STEP
    state = system.fit(max_steps=SPLIT_STAGE1_STEP + steps,
                       seed=int(cfg["seed"]), state=state, log_every=0)
    view_sys = test_system(system, n_images=1)
    split = view_sys.datamodule.test()
    with torch.no_grad():
        view = view_sys.render_image(state, split, 0)
    rays, inv = view_sys.view_rays(split, 0)
    rays = (rays if inv is None else rays[inv]).cpu()
    step, n = int(state["step"]), rays.shape[0]
    d = rays[:, 3:]
    nrm = torch.from_numpy(view["comp_normal"]).reshape(n, 3)
    length = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    rng = np.random.default_rng(PBR_SEED)
    host = {"pos": rays[:, :3] + torch.from_numpy(view["depth"]).reshape(
                n, 1) * d,
            "dirs": d,
            "normals": torch.where(length > 0.5,
                                   nrm / length.clamp(min=1e-6), -d),
            "albedo": torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(
                np.float32)),
            "rough": torch.from_numpy(rng.uniform(0.05, 1, (n, 1)).astype(
                np.float32)),
            "metal": torch.from_numpy(rng.uniform(0, 1, (n, 1)).astype(
                np.float32))}
    pbr = models.make("volume-pbr", {"name": "volume-pbr",
                                     "scatterer": {"name": "brdf-ggx"}})
    u_host = pbr.scatterer.draw_uniforms(
        (n,), torch.Generator().manual_seed(PBR_SEED))
    card = {k: v.cuda() for k, v in host.items()}
    u_card = tuple(v.cuda() for v in u_host)
    model = system.model
    cpu_model = models.make(cfg["model"]["name"], cfg["model"])
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    occ = state["occ_binary"]
    with torch.no_grad():
        bake = model.bake_eval_sdf(step)
    host_bake = bake and {k: v.cpu() if torch.is_tensor(v) else v
                          for k, v in bake.items()}

    @torch.no_grad()
    def shade(m, x, u, occ_, bake_, sl):
        rec = {}

        def indirect(o, dd):
            tr = m.compute_indirect_radiance(o, dd, occ_, step, frac=1.0,
                                             bake=bake_)[0]
            feat = m.geometry(o, step, with_grad=False,
                              with_feature=True)["feature"]
            rec["tr"], rec["dirs"] = tr, dd
            rec["sec"] = m.texture.secondary_shading(feat, dd,
                                                     x["normals"][sl],
                                                     step=step)
            return rec["tr"], rec["sec"]

        rec.update(pbr(x["pos"][sl], x["dirs"][sl], x["normals"][sl],
                       x["albedo"][sl], x["rough"][sl], x["metal"][sl],
                       indirect, m.emitter,
                       uniforms=tuple(v[sl] for v in u)))
        return {k: v.cpu() for k, v in rec.items()}

    chunks = [slice(s, s + PBR_CHUNK) for s in range(0, n, PBR_CHUNK)]

    def card_pass():
        return [shade(model, card, u_card, occ, bake, sl) for sl in chunks]

    runs = [card_pass() for _ in range(3)]
    torch.use_deterministic_algorithms(True)
    try:
        det = [card_pass() for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    keys = list(runs[0][0])

    def spread(a, b):
        return {k: max(float((x[k] - y[k]).abs().max())
                       for x, y in zip(a, b)) for k in keys}

    res = {"step": step, "card_repeats": spread(runs[0], runs[1]),
           "card_repeats_2": spread(runs[0], runs[2]),
           "deterministic_repeats": spread(det[0], det[1]),
           "deterministic_vs_default": spread(det[0], runs[0]),
           "chunks": [], "worst": None, "chunks_same_dirs": [],
           "worst_same_dirs": None}

    def compare(c, sl, got, cpu, tag):
        res["chunks" + tag].append({k: float((got[k] - cpu[k]).abs().max())
                                    / max(1.0, float(cpu[k].abs().max()))
                                    for k in keys})
        diff = (got["rgb_phys"] - cpu["rgb_phys"]).abs().amax(-1)
        i = int(diff.argmax())
        worst = res["worst" + tag]
        if worst is None or float(diff[i]) > worst["err"]:
            g = sl.start + i
            res["worst" + tag] = {
                "err": float(diff[i]), "chunk": c,
                "pixel": [g // split.w, g % split.w],
                "rough": float(host["rough"][g, 0]),
                **{f"{k}_card": got[k][i].tolist() for k in keys},
                **{f"{k}_cpu": cpu[k][i].tolist() for k in keys}}

    for c, sl in enumerate(chunks):
        got = runs[0][c]
        compare(c, sl, got, shade(cpu_model, host, u_host, occ.cpu(),
                                  host_bake, sl), "")
        with fixed_directions(pbr.scatterer, got["dirs"]):
            compare(c, sl, got, shade(cpu_model, host, u_host, occ.cpu(),
                                      host_bake, sl), "_same_dirs")
    shutil.rmtree(save, ignore_errors=True)
    shutil.rmtree(os.path.join("exp", "test_protocol"), ignore_errors=True)
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


DDP_STEPS = 16


def ddp_plan():
    """The data-parallel window's ranks and backend on this machine:
    NCCL with one rank per GPU (up to 4) when two or more are visible,
    else two gloo ranks that share ``cuda:0``."""
    n = torch.cuda.device_count()
    return (min(n, 4), "nccl") if n >= 2 else (2, "gloo")


def _check_reduced(post, pre, world, group=None):
    """The all-reduced gradient ``post`` against the float64 mean of
    the ``world`` ranks' ``pre`` of ``group`` (gathered; the world by
    default): the entries out of bound and the
    largest relative error.  At two ranks the bound is one float32 ulp
    (2^-23) of the mean, relative: the sum of two is one rounding and
    the halving is exact.  At more, it is the float32 sum's bound in any
    order, 2^-24 ((n - 1) mean|g| + |mean|)."""
    import torch.distributed as dist

    parts = [torch.empty_like(pre) for _ in range(world)]
    dist.all_gather(parts, pre, group=group)
    stacked = torch.stack(parts).double()
    del parts
    mean = stacked.mean(0)
    mag = mean.abs()
    if world == 2:
        bound = 2.0 ** -23 * mag
    else:
        bound = 2.0 ** -24 * ((world - 1) * stacked.abs().mean(0) + mag)
    del stacked
    err = (post.double() - mean).abs()
    return {"entries": int(mean.numel()), "over_bound": int(
        (err > bound).sum()),
            "max_rel_err": float((err / mag.clamp_min(1e-30)).max()),
            "max_abs_mean": float(mag.max())}


def _ranks_agree(system, state) -> bool:
    """Are the replicated params and the occupancy grid bit-equal on
    every rank, and each table shard on its data group?"""
    import torch.distributed as dist

    mesh = system.mesh
    shards = {id(p) for p in system.table_shards()}
    params = list(system.model.parameters())
    equal = True
    for group, ts in ((None, [p for p in params if id(p) not in shards]
                       + [state["occs"]]),
                      (mesh.data_group,
                       [p for p in params if id(p) in shards])):
        if not ts:
            continue
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        parts = [torch.empty_like(flat)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, flat, group=group)
        equal &= all(torch.equal(parts[0], q) for q in parts[1:])
    return equal


def _ddp_rank(rank, world, steps, out_dir, validate, cfg, device):
    """One rank of ``ddp_window``: the system of ``cfg`` from a fresh
    init at stage 1 for ``steps`` steps, then the checks and the numbers
    of its docstring, written to ``out_dir/rank{rank}.json``."""
    import torch.distributed as dist

    from . import datasets, systems
    from .bench import _sync
    from .ops.gather import gather_rows
    from .ops.hashgrid import ReduceFrom
    from .ops.scatter import scatter_add
    from .parallel import sharding
    from .parallel.dryrun import rank_device

    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(cfg.get("seed", 42))
    t0 = time.perf_counter()
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=os.path.join(out_dir, "save"),
                          device=str(dev))
    build_s = time.perf_counter() - t0
    mesh = system.mesh
    table = system.model.geometry.encoding.encoding.table
    state = system.init_state(seed)
    state["step"] = SPLIT_STAGE1_STEP
    # this rank's table gradient before the all-reduce, at the first
    # step after the window's first occupancy sweep
    pre, rec, stamps, per_step, check = {}, {"on": False}, [], [], {}
    table.register_post_accumulate_grad_hook(
        lambda p: pre.__setitem__("g", p.grad.clone()) if rec["on"]
        else None)

    def on_log(step, m):
        stamps.append(time.perf_counter())
        per_step.append((step, scatter_add.launches, gather_rows.launches,
                         m["loss"], m["skipped_nonfinite"]))
        if step == SPLIT_PROFILE_FROM:
            # a table shard's gradient is reduced over its data group
            sharded = mesh.tp > 1
            check.update(_check_reduced(
                table.grad, pre.pop("g"), mesh.dp if sharded else world,
                mesh.data_group if sharded else None))
        rec["on"] = step == SPLIT_PROFILE_FROM - 1

    _sync(dev)
    scatter_add.launches = gather_rows.launches = 0
    ReduceFrom.bytes = 0
    t0 = time.perf_counter()
    state = system.fit(max_steps=SPLIT_STAGE1_STEP + steps, seed=seed,
                       state=state, log_every=1, on_log=on_log)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    k1, g1 = scatter_add.launches, gather_rows.launches
    model_mb = ReduceFrom.bytes / 1e6 / max(len(per_step), 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else None
    last, launches = (0, 0), []
    for _, k, g, _, _ in per_step:
        launches.append([k - last[0], g - last[1]])
        last = (k, g)
    # the rate over the steps after the first 4 (one occupancy sweep in)
    warm = min(4, len(stamps) - 2)
    rate = (len(stamps) - 1 - warm) / (stamps[-1] - stamps[warm])

    params = list(system.model.parameters())
    shards = {id(p) for p in system.table_shards()}
    replicated = [p for p in params if id(p) not in shards]
    tables = [p for p in params if id(p) in shards]
    equal = _ranks_agree(system, state)
    # a step's gradient all-reduces, as train_step takes them
    buckets = [([torch.zeros_like(p) for p in replicated], None),
               ([torch.zeros_like(p) for p in tables], mesh.data_group)]
    times = []
    for i in range(13):
        dist.barrier()
        _sync(dev)
        t = time.perf_counter()
        for bucket, group in buckets:
            sharding.all_reduce_mean_(bucket, group)
        _sync(dev)
        if i >= 3:
            times.append((time.perf_counter() - t) * 1e3)
    del buckets
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(dev), "card": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else None,
           "build_s": build_s, "steps": len(per_step), "fit_s": fit_s,
           "steps_per_s": rate, "k1_launches": k1, "g1_launches": g1,
           "launches_per_step": launches,
           "losses": [x[3] for x in per_step],
           "skipped": system.skipped_updates, "peak_gib": peak,
           "grad_check": check, "params_equal": equal,
           "allreduce_ms": float(np.median(times)),
           "allreduce_mb": 4 * sum(p.numel() for p in params) / 1e6,
           "allreduce_mb_world": 4 * sum(p.numel() for p in replicated)
           / 1e6,
           "allreduce_mb_data": 4 * sum(p.numel() for p in tables) / 1e6
           if mesh.dp > 1 else 0.0,
           "allreduce_mb_model": model_mb, "mesh": list(mesh[:4]),
           "ckpt": os.path.join(system.ckpt_dir,
                                f"step_{int(state['step'])}.ckpt.npz"),
           "rays_per_rank": system.rank_counts(system.capacity)[0]}
    if validate:
        images, render = [], system.render_image

        def keep(*args, **kw):
            images.append(render(*args, **kw))
            return images[-1]

        system.render_image = keep
        gather_rows.launches = scatter_add.launches = 0
        t0 = time.perf_counter()
        res["val"] = system.validate(state, n_images=1)
        _sync(dev)
        res["val_s"] = time.perf_counter() - t0
        res["val_launches"] = [scatter_add.launches, gather_rows.launches]
        del system.render_image
        if rank == 0:
            np.savez(os.path.join(out_dir, "val_view0.npz"), **images[0])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def ddp_window(world, backend, out_dir, steps=DDP_STEPS, validate=True,
               cfg=None, device="cuda", table_shards=1):
    """The flagship (``split_mixed_occ_train_full``, full width; or the
    split-occ config ``cfg``) over ``world`` data-parallel ranks on the
    card(s), or the CPU with ``device="cpu"`` (``parallel.dryrun.
    rank_device``): a fresh init at stage 1 (``SPLIT_STAGE1_STEP``)
    trained ``steps`` steps through ``fit``, with K1's and G1's counts
    zeroed just before and read just after, then with ``validate`` one
    view of the validation split, sharded over the ranks.  Each rank
    reports its steps/s over the steps after the first 4, K1's and G1's
    launches in all and per step, losses, skipped updates, peak device
    memory, the all-reduced table gradient of step ``SPLIT_PROFILE_FROM``
    against the float64 mean of every rank's own (``_check_reduced``),
    whether every rank's params and occupancy grid are bit-equal after
    the window, and the all-reduce's median ms (10 runs after 3 warm-ups,
    between barriers) and MB on a bucket of the params' size (a step
    adds the aux's few scalars).  Rank 0
    writes the final checkpoint (its path is ``ckpt``) and, with
    ``validate``, the view's images (``out_dir/val_view0.npz``).
    ``world`` 1 runs in this process, more ranks are spawned.  With
    ``table_shards`` (``system.table_shards``) the hash tables' rows
    split over that many ranks of each data index.  Returns the ranks'
    reports."""
    import tempfile

    import torch.distributed as dist

    from .parallel import dryrun, sharding
    from .presets import split_mixed_occ_train_full

    if SPLIT_STAGE1_STEP + steps <= SPLIT_PROFILE_FROM:
        raise ValueError(f"the window checks the gradient of step "
                         f"{SPLIT_PROFILE_FROM}: it needs more than "
                         f"{SPLIT_PROFILE_FROM - SPLIT_STAGE1_STEP} steps")
    cfg = cfg or split_mixed_occ_train_full()
    cfg["system"]["table_shards"] = table_shards
    os.makedirs(out_dir, exist_ok=True)
    if world > 1:
        dryrun.spawn(_ddp_rank, world, backend,
                     args=(steps, out_dir, validate, cfg, device))
    else:
        tmp = tempfile.mkdtemp(prefix="rise_rank_")
        sharding.initialize_distributed(
            backend, f"file://{os.path.join(tmp, 'rendezvous')}", rank=0,
            world_size=1, local_rank=0)
        try:
            _ddp_rank(0, 1, steps, out_dir, validate, cfg, device)
        finally:
            dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


TABLE_SHARD_STEPS = 8
VAL_CHUNKS = 8  # the validation chunks a table-shard window renders
EXPORT_RES = 256  # its export's isosurface resolution


def val_chunks(system, n=VAL_CHUNKS):
    """The rays of ``n`` chunks of validation view 0 (in the eval ray
    order, from the view's middle), for a partial ``render_image``: its
    split and a ``view_rays`` that returns them."""
    split = system.datamodule.val()
    rays, _ = system.view_rays(split, 0)
    chunk = system.eval_chunk
    start = max(rays.shape[0] // 2 - n * chunk // 2, 0)
    part = rays[start:start + n * chunk]
    return split, lambda *_: (part, None)


def _table_shard_rank(rank, world, steps, out_dir, cfg, device, ckpt):
    """One rank of ``table_shard_window`` (its docstring)."""
    import torch.distributed as dist

    from . import bridge, datasets, systems
    from .bench import _sync
    from .ops.gather import gather_rows
    from .ops.hashgrid import ReduceFrom
    from .ops.scatter import scatter_add
    from .parallel.dryrun import rank_device

    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(cfg.get("seed", 42))
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=os.path.join(out_dir, "save"),
                          device=str(dev))
    mesh = system.mesh
    state = system.init_state(seed)
    state["step"] = SPLIT_STAGE1_STEP
    if ckpt is not None:
        state = system.load_checkpoint(ckpt)
    start = int(state["step"])
    stamps, per_step = [], []

    def on_log(step, m):
        stamps.append(time.perf_counter())
        per_step.append((scatter_add.launches, gather_rows.launches,
                         m["loss"], m["skipped_nonfinite"]))
        if step == start:  # the first step's reduced gradients
            torch.save({k: p.grad.cpu() for k, p in
                        system.model.named_parameters()},
                       os.path.join(out_dir, f"grads{rank}.pt"))

    _sync(dev)
    scatter_add.launches = gather_rows.launches = 0
    ReduceFrom.bytes = 0
    t0 = time.perf_counter()
    state = system.fit(max_steps=start + steps, seed=seed, state=state,
                       log_every=1, on_log=on_log)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    model_mb = ReduceFrom.bytes / 1e6 / steps
    launches, last = [], (0, 0)
    for k, g, _, _ in per_step:
        launches.append([k - last[0], g - last[1]])
        last = (k, g)
    params = list(system.model.parameters())
    shards = {id(p) for p in system.table_shards()}
    equal = _ranks_agree(system, state)
    flat = bridge.to_jax_state(system.model, system.optimizer,
                               system.scheduler)
    np.savez(os.path.join(out_dir, f"state{rank}.npz"), **flat)
    del flat
    split, system.view_rays = val_chunks(system)
    gather_rows.launches = scatter_add.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        view = system.render_image(state, split, 0)
    _sync(dev)
    val_s = time.perf_counter() - t0
    val_launches = [scatter_add.launches, gather_rows.launches]
    if rank == 0:
        np.savez(os.path.join(out_dir, "view.npz"), **view)
    t0 = time.perf_counter()
    exported = system.export(state)
    _sync(dev)
    res = {"rank": rank, "world": world, "mesh": list(mesh[:4]),
           "backend": dist.get_backend(), "device": str(dev),
           "steps": len(per_step), "fit_s": fit_s,
           "steps_per_s": (len(stamps) - 2) / (stamps[-1] - stamps[1]),
           "launches_per_step": launches,
           "losses": [x[2] for x in per_step],
           "skipped": system.skipped_updates, "params_equal": equal,
           "allreduce_mb_model": model_mb,
           "allreduce_mb_world": 4 * sum(
               p.numel() for p in params if id(p) not in shards) / 1e6,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
           if dev.type == "cuda" else None,
           "val_s": val_s, "val_launches": val_launches,
           "export_s": time.perf_counter() - t0,
           "vertices": None if exported is None
           else int(exported["v_pos"].shape[0]),
           "ckpt": os.path.join(system.ckpt_dir,
                                f"step_{int(state['step'])}.ckpt.npz")}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def table_shard_window(world, backend, out_dir, steps=TABLE_SHARD_STEPS,
                       table_shards=2, cfg=None, device="cuda", ckpt=None):
    """The flagship (``split_mixed_occ_train_full``, full width; or the
    split-occ config ``cfg``) at ``system.table_shards`` over ``world``
    spawned ranks: a fresh init at stage 1, or the checkpoint ``ckpt``,
    trained ``steps`` steps
    through ``fit`` (K1's and G1's counts zeroed just before), then
    ``VAL_CHUNKS`` chunks of validation view 0 and the export
    (``system.export``: rank 0 from the gathered tables; the flagship's
    at ``EXPORT_RES``^3).  Each rank writes its first step's reduced gradients
    (``out_dir/grads{rank}.pt``), its whole state with its rows of each
    table (``state{rank}.npz``) and a report (``rank{rank}.json``):
    steps/s over the steps after the first, K1's and G1's launches per
    step, losses, skipped updates, whether the replicated params and
    the grid are bit-equal on every rank and each table shard on its
    data group, the MB per step of the gradient all-reduce over the
    world and of the encodes' feature all-reduces over the model group,
    peak device memory, the render's and the export's seconds and
    launches, the vertex count and the final checkpoint's path (rank 0
    writes it); rank 0 also the view (``view.npz``).  Returns the
    reports."""
    from .parallel import dryrun
    from .presets import split_mixed_occ_train_full

    if cfg is None:
        cfg = split_mixed_occ_train_full()
        cfg["model"]["geometry"]["isosurface"]["resolution"] = EXPORT_RES
    cfg["system"]["table_shards"] = table_shards
    os.makedirs(out_dir, exist_ok=True)
    dryrun.spawn(_table_shard_rank, world, backend,
                 args=(steps, out_dir, cfg, device, ckpt))
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def main(argv=None):
    from . import datasets, systems
    from .presets import neus_sphere_full

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=("neus", "split", "test",
                                         "determinism", "ddp", "pbr"),
                    default="neus")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--table-shards", type=int, default=1,
                    help="--preset ddp: system.table_shards")
    ap.add_argument("--views", type=int, default=None,
                    help="--preset test: test views (at least 2; 4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.preset == "split":
        res = _split_main(args.steps or 32)
    elif args.preset == "test":
        if args.views is not None and args.views < 2:
            raise SystemExit("measure: --views takes 2 or more (view 1 is "
                             "profiled)")
        res = _test_main(args.steps or 32, args.views)
    elif args.preset == "determinism":
        res = _determinism_main(args.steps or 32)
    elif args.preset == "pbr":
        res = _pbr_main(args.steps or 32)
    elif args.preset == "ddp":
        world, backend = ddp_plan()
        out = os.path.join("exp", "measure_ddp")
        res = {"ranks": ddp_window(world, backend, out,
                                   args.steps or DDP_STEPS,
                                   table_shards=args.table_shards)}
        shutil.rmtree(out, ignore_errors=True)
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
