#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--steps 120] [--split-steps 32]
                          [--test-views 4] [--resume-steps 32]
                          [--save-streams FILE]

Phases, each of which fails the run (non-zero exit) when it fails:

1. card: name and power limit from ``nvidia-smi``, torch and CUDA versions;
2. build the kernels K1 (``rise_sdf_tpu_torch/csrc/scatter_add.cu``) and
   G1 (``csrc/gather_rows.cu``) with nvcc, one process per source, both
   at once;
3. K1 against a float64 ``index_add_`` reference at the JAX test shapes,
   at S1's shape (12,582,912 rows into 2^19 x 2) and at the main-path
   shape (16 levels x 2^19 x 2, 8,388,608 rows per level, walked with the
   encode's period 128), per entry ``|K1 - ref| <= 1e-5 * S + 1e-7``
   with ``S`` the sum of ``|v|`` landing on that entry; median-of-10
   times (each over 10 back-to-back calls) of K1, of its plain version
   and of ``index_add_``;
4. G1 bit-equal to ``index_select`` at S2/S3's shape (8,388,608 rows from
   2^19 x 2), at S4's (4,194,304 rows from 2^19 x w, w = 2, 8, 32), at
   the render's (one chunk's hash encode and baked-SDF probe) and at the
   main-path shape (134,217,728 rows from 8,388,608 x 2); median-of-10
   times of G1, of its plain version and of ``index_select``;
5. small-input references, card against CPU: the tiny NeuS config's loss
   and gradients (K1 against the plain scatter), the tiny split config's
   eval render with prefilter, bands and the full bake (G1 against the
   plain gather), the same render through ``forward_multi`` under the
   learned light and a second light with the third bounce, and one tiny
   split train step at stage 0 and at stage
   1 with the prefilter (hybrid FD, curvature probe, mips in the loss:
   loss and every gradient), all in float64;
6. render slice: ``rise_sdf_tpu_torch.bench`` at 800x800 (the flagship
   ``split_mixed_occ_full`` at full width, the headline protocol of the
   JAX package's ``bench.py``), G1 and K1 counts zeroed just before and
   read just after: the image must be finite, G1 must launch and K1 must
   not.  The band-sample hash encode of one chunk from the middle of the
   image is recorded (the render stream); G1 is held to and timed
   against ``index_select`` on its rows;
7. training slice: the NeuS system at ``neus_sphere_full`` widths (hash
   grid 16 x 2^19 x 2, 4096 rays x 1024 samples into a 1,048,576-sample
   buffer) on the synthetic sphere at 800x800, trained through
   ``datasets.make`` / ``systems.make`` / ``fit`` for ``--steps`` steps,
   then ``validate`` on one view.  The counts are zeroed just before and
   read just after; at steps 0 and 1 the table gradient is recomputed
   with the plain scatter on the same cotangent.  Steps 41-45 run under
   ``torch.profiler`` (K1's and G1's device time and launches per step;
   ``rise_sdf_tpu_torch.measure`` holds the timing code).
   Step 1's rows, cotangent and table (the training stream) are kept;
   after the slice K1 and G1 are checked and timed on them.  For both
   recorded streams the script prints the runs of equal rows down the
   ``[N, L, 8]`` layout's columns, which K1 adds up before its atomics;
8. flagship training: the split-occ system at
   ``split_mixed_occ_train_full`` widths (hash grid 16 x 2^19 x 2, 4096
   rays, hybrid-FD normals with the shared-probe encode, the curvature
   probe on 1/4 of the samples, five bf16 heads, a 512^2 emitter) on the
   synthetic sphere at 800x800, in two windows of ``--split-steps``
   steps from one fresh init each (``rise_sdf_tpu_torch.measure.
   train_split``): stage 0 from step 0 and stage 1 (prefilter, mips in
   the loss, secondary pass) from step 13000, then ``validate`` on one
   view.  The counts are zeroed just before and read just after; K1 and
   G1 must launch on every step, losses stay finite with no skipped
   update, and validation gives finite PSNR and phys PSNR with no
   dropped ray.  At stage-1 step 13009, the first after the window's
   first occupancy sweep, every encode's rows and cotangent are recorded
   and the table gradient is held to the plain scatter of them, per entry
   ``1e-5 * S + 1e-7``; K1 (period 96) and G1 are then checked and timed
   on that step's shared-probe rows ``[N, 3, 32]`` (the probe stream).
   Steps 13010-13014 run under ``torch.profiler`` (K1's and G1's device
   ms and launches per flagship step);
9. test protocol: ``SplitOccSystem.test`` on the stage-1 state that
   phase 8 leaves (step 13031), at ``split_mixed_occ_test_full``: the
   calibrated compaction fractions, then ``--test-views`` 800x800 test
   views (4) under the learned light and the ``warm`` and ``bright``
   environments in one geometry pass per chunk (``forward_multi``, the
   third bounce on); then view 0 again
   in single-light mode, one render per light
   (``rise_sdf_tpu_torch.measure.test_protocol``).  The counts are
   zeroed just before and read just after: G1 must launch and K1 must
   not (no table gradient at eval); every metric is finite, no ray is
   dropped after escalation, view 0's metrics in single-light mode are
   within 1e-3 of the multi-emitter render's (the bound of the JAX
   package's test of the two modes) and its images within 1e-4 in max
   |difference|: an eval render scans and accumulates deterministically
   on the card (``ops/volrend.py``), so the two modes give the same
   images (on the CPU they are bit-equal,
   ``tests/test_torch_test_protocol.py``);
10. a flagship run's lifecycle, on phase 8's trained system and its
   stage-1 state at ``split_mixed_occ_test_full``: (a) the whole
   training state saved synchronously (seconds and MB printed); (b) a
   new system and ``load_checkpoint``: every param, Adam moment and
   count, the schedule's count, ``occs``, ``occ_binary`` and ``step``
   bit-equal to the source; (c) ``fit`` from the loaded state for
   ``--resume-steps`` steps (32) with ``trainer.save_every_n_steps`` 16
   and ``val_every`` 32: K1 and G1 launch on every step, no update is
   skipped, the one validation view has a finite PSNR and phys PSNR (its
   dropped rays are printed: the fresh-init field of these steps
   outgrows the 4x eval buffer on some rays); (d) ``export`` at ``isosurface.resolution`` 512, counts zeroed
   just before and read just after: G1 must launch and K1 must not; the
   vertex and face counts, the grid-eval, marching and attribute
   seconds and the peak device memory are printed, and the PLY must read
   back with the same counts and vertices inside [-r, r]^3, the albedo,
   metallic and roughness arrays finite in [0, 1]; then
   ``latest.ckpt.npz`` must load back at the step after its last save;
   (e) ``python -m rise_sdf_tpu_torch.launch --preset
   split_mixed_occ_test_full --test --resume <a's file>
   dataset.n_images=1`` as a subprocess: exit 0, the test PNGs and the
   PLY in the trial's ``save/``, the wall time printed.

``--save-streams FILE`` saves both recorded streams for the same-call
A/B against another tree, ``python -m rise_sdf_tpu_torch.kernel_ab``
(``_ab/streams.pt``, about 1.7 GB, in the gitignored ``_ab/``).
The last two lines are the kernels' JSON record (K1's and G1's entries
also carry their times on the recorded streams and per NeuS and flagship
train step, G1's its launches in the test protocol, both their launches
in phase 10's resumed run and G1's in its export) and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

SRC_K1 = "rise_sdf_tpu_torch/csrc/scatter_add.cu"
SRC_G1 = "rise_sdf_tpu_torch/csrc/gather_rows.cu"
REPLACES_K1 = "rise_sdf_tpu/ops/scatter_pallas.py:49"
REPLACES_S1 = "scripts/scatter_kernel_bench.py:33"
REPLACES_G1 = ("scripts/pallas_gather_bench.py:79 (S2), "
               "scripts/pallas_gather_bench.py:128 (S3), "
               "scripts/r5_gather_width_bench.py:52 (S4)")
F = 2
# the render chunk whose hash encode is recorded (of 157)
RENDER_CHUNK = 78
# the card's memory rate for the bounds (H100 SXM, 3.35 TB/s); scatter
# adds count against float32 outside the tensor cores (67 TFLOP/s)
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def scatter_bound_ms(m, f, table_size):
    """Least time of ``zeros[T, F].at[idx].add(vals)``: idx and vals read
    once, the table written once; or m * f adds at the float32 rate."""
    moved = m * 4 + m * f * 4 + table_size * f * 4
    return max(moved / HBM_BYTES_PER_S, m * f / F32_OPS_PER_S) * 1e3


def gather_bound_ms(m, w, rows):
    """Least time of ``table[idx]``: idx read once, each of the ``rows``
    distinct table rows it names read once, the output written once (a
    gather does no arithmetic)."""
    return (m * 4 + rows * w * 4 + m * w * 4) / HBM_BYTES_PER_S * 1e3


def check_scatter(torch, got, idx, vals, table_size, what):
    """|got - ref64| <= 1e-5 * S + 1e-7 per entry; returns max abs error."""
    idx64 = idx.long()
    ref = torch.zeros((table_size, vals.shape[1]), dtype=torch.float64,
                      device=vals.device).index_add_(0, idx64, vals.double())
    s = torch.zeros_like(ref).index_add_(0, idx64, vals.double().abs())
    err = (got.double() - ref).abs()
    bad = int((err > 1e-5 * s + 1e-7).sum())
    max_err = float(err.max())
    log(f"  {what}: max |K1 - ref64| = {max_err:.3e}, "
        f"entries over bound = {bad}")
    if bad or not torch.isfinite(got).all():
        fail(f"K1 disagrees with the float64 reference at {what}")
    return max_err


def check_time_scatter(torch, scatter, idx, vals, t, what, period=1):
    """K1 held to the float64 reference, then timed (K1, plain,
    ``index_add_``)."""
    got = scatter.scatter_add(idx, vals, t, period)
    torch.cuda.synchronize()
    res = {"max_abs_err": check_scatter(torch, got, idx, vals, t, what)}
    del got
    res.update(time_scatter(torch, scatter, idx, vals, t, what, period))
    return res


def time_scatter(torch, scatter, idx, vals, t, what, period=1):
    """Median-of-10 times of K1, its plain version and ``index_add_``."""
    from rise_sdf_tpu_torch.measure import median_ms

    ms = median_ms(lambda: scatter.scatter_add(idx, vals, t, period))
    plain_ms = median_ms(lambda: scatter.scatter_add_plain(idx, vals, t))
    lib_ms = median_ms(lambda: torch.zeros(
        (t, vals.shape[1]), device="cuda").index_add_(0, idx, vals))
    bound = scatter_bound_ms(idx.shape[0], vals.shape[1], t)
    log(f"  {what}: K1 {ms:.3f} ms, plain {plain_ms:.3f} ms, index_add_ "
        f"{lib_ms:.3f} ms, bound {bound:.4f} ms (bytes; median of 10)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "bound_by": "bytes"}


def kernel_phase(torch, scatter):
    from rise_sdf_tpu_torch.measure import k1_shapes

    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, t in ((3 * 8192 + 100, 4096), (8192, 35937)):
        idx = torch.randint(0, t, (m,), generator=gen, device="cuda",
                            dtype=torch.int32)
        vals = torch.randn((m, F), generator=gen, device="cuda")
        got = scatter.scatter_add(idx, vals, t)
        torch.cuda.synchronize()
        check_scatter(torch, got, idx, vals, t, f"{m} rows into {t}")
    # S1's shape, then the main path's
    s1, k1 = (check_time_scatter(torch, scatter, idx, vals, t, what, period)
              for what, (idx, vals, t, period) in k1_shapes(gen))
    torch.cuda.empty_cache()
    return k1, s1


def check_gather(torch, gather, table, idx, what):
    """G1 bit-equal to ``index_select``; median-of-10 times of G1, of its
    plain version and of ``index_select`` on the int32 rows."""
    from rise_sdf_tpu_torch.measure import median_ms

    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    want = table.index_select(0, idx.long())
    equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
    del got, want
    ms = median_ms(lambda: gather.gather_rows(table, idx))
    plain_ms = median_ms(lambda: gather.gather_rows_plain(table, idx))
    lib_ms = median_ms(lambda: torch.index_select(table, 0, idx))
    (n, w), m = table.shape, idx.shape[0]
    rows = int(torch.unique(idx).numel())
    bound = gather_bound_ms(m, w, rows)
    log(f"  {what}: {m} rows ({rows} distinct) from {n} x {w}: bit-equal "
        f"{equal}; G1 {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms (bytes; median of 10)")
    if not equal:
        fail(f"G1 differs from index_select at {what}")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": "bytes"}


def gather_phase(torch, gather):
    """G1 at S2/S3's, S4's, one render chunk's and the main path's
    shapes; returns the main path's record."""
    from rise_sdf_tpu_torch.measure import g1_shapes

    gen = torch.Generator(device="cuda").manual_seed(1)
    for what, (table, idx) in g1_shapes(gen):
        res = check_gather(torch, gather, table, idx, what)
        del table, idx
    torch.cuda.empty_cache()
    return res


def small_reference_phase(torch):
    """Tiny-config loss and gradients: card (K1) vs CPU (plain scatter)."""
    from rise_sdf_tpu_torch import datasets, presets, systems

    cfg = presets.tiny_neus_config()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    runs, batch = {}, None
    for dev in ("cpu", "cuda"):
        system = systems.make(cfg["system"]["name"], cfg, dm,
                              save_dir=os.path.join("exp", "chip_smoke"),
                              device=dev)
        # float64 everywhere but inside K1 (float32 atomics), so the two
        # sides differ by K1's rounding and not by the float32 scan's
        # summation order; params drawn on the CPU, then perturbed so the
        # table gradient is not zero (the sphere-init first layer reads
        # xyz only)
        system.init_state(0)
        gen = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for p in system.model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen).to(dev))
        system.model.double()
        if batch is None:
            batch = system.sample_batch(torch.Generator().manual_seed(1),
                                        system.device_data(dm.train()))
        grid = torch.ones(system.model.grid_resolution ** 3,
                          dtype=torch.bool, device=dev)
        loss, _ = system.forward_loss(
            {k: (v.double() if v.is_floating_point() else v).to(dev)
             for k, v in batch.items()}, grid, 5)
        loss.backward()
        runs[dev] = (float(loss.detach()),
                     {k: p.grad.detach().cpu()
                      for k, p in system.model.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    worst = 0.0
    for k in g_cpu:
        scale = float(g_cpu[k].abs().max())
        if scale == 0:
            fail(f"zero gradient for {k}: the check would compare nothing")
        worst = max(worst, float((g_gpu[k] - g_cpu[k]).abs().max()) / scale)
    log(f"  tiny config in float64: loss cpu {l_cpu:.12f} cuda {l_gpu:.12f};"
        f" worst gradient difference {worst:.2e} of its tensor's largest "
        f"entry")
    if not abs(l_gpu - l_cpu) <= 1e-9 * abs(l_cpu) or not worst <= 1e-5:
        fail("card and CPU disagree on the tiny config's loss or gradients")


def render_reference_phase(torch, gather):
    """The tiny split config's eval render with prefilter, bands and the
    full bake (set up as ``tests/test_sdf_bake.py`` does): card (G1)
    against CPU (plain gather), both in float64 on the same params."""
    import copy

    from rise_sdf_tpu_torch import models
    from rise_sdf_tpu_torch.presets import tiny_split_config

    cfg = tiny_split_config()["model"]
    cfg["variance"]["init_val"] = 0.7  # inv_s ~ 1097
    cfg.update({"num_samples_per_ray": 256, "visibility_prefilter": True,
                "prefilter_stride": 4, "prefilter_margin_intervals": 1.0,
                "eval_sdf_bake": "full", "eval_sdf_bake_cells": 96})
    model = models.make(cfg["name"], cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    b = torch.linspace(-0.45, 0.45, 32, dtype=torch.float64)
    d = torch.stack([torch.zeros_like(b), b / 4.0, torch.ones_like(b)], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    rays = torch.cat([torch.tensor([[0.0, 0.0, -4.0]],
                                   dtype=torch.float64).expand(32, 3), d], -1)
    runs, multi = {}, {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).double().to(dev).requires_grad_(False)
        before = gather.gather_rows.launches
        mips = m.emitter.build_mips()
        bake = m.bake_eval_sdf(20)
        kw = dict(occ_binary=torch.ones(
            m.grid_resolution ** 3, dtype=torch.bool, device=dev),
            step=20, stage=1, capacity=768,
            background_color=torch.ones(3, dtype=torch.float64, device=dev),
            prefilter=True, banded=True, bake=bake)
        out = m(rays.to(dev), mips=mips, **kw)
        runs[dev] = ({k: v.cpu() for k, v in out.items()},
                     gather.gather_rows.launches - before)
        # a second light: the learned one brightened and channel-rolled
        before = gather.gather_rows.launches
        mips1 = m.emitter.build_mips(torch.roll(m.emitter.base * 1.7 + 0.05,
                                                1, -1))
        outs = m.forward_multi(rays.to(dev), mips_list=[mips, mips1],
                               relight_flags=(False, True), **kw)
        multi[dev] = ([{k: v.cpu() for k, v in o.items()} for o in outs],
                      gather.gather_rows.launches - before)
    (cpu, _), (gpu, launches) = runs["cpu"], runs["cuda"]
    worst = max(float((gpu[k] - cpu[k]).abs().max())
                for k in ("comp_rgb_full", "opacity", "depth"))
    same = all(torch.equal(gpu[k], cpu[k]) for k in (
        "ray_included", "stat_live", "stat_vis", "stat_secondary_live"))
    log(f"  tiny split render in float64: max |card - CPU| over "
        f"comp_rgb_full, opacity, depth = {worst:.2e}; ray_included and "
        f"stats equal: {same}; rays included "
        f"{int(cpu['ray_included'].sum())}/32; G1 launches {launches}")
    if not (worst <= 1e-9 and same and launches > 0
            and bool(cpu["ray_included"].all())):
        fail("card and CPU disagree on the tiny split render")
    (cpu, _), (gpu, launches) = multi["cpu"], multi["cuda"]
    worst = max(float((g[k] - c[k]).abs().max()) for g, c in zip(gpu, cpu)
                for k in ("comp_rgb_full", "opacity", "depth",
                          "comp_rgb_phys_full"))
    same = all(torch.equal(gpu[0][k], cpu[0][k]) for k in (
        "ray_included", "stat_live", "stat_vis", "stat_secondary_live"))
    lights = float((cpu[0]["comp_rgb_phys_full"]
                    - cpu[1]["comp_rgb_phys_full"]).abs().max())
    glossy = int(((cpu[0]["comp_roughness"] <= 0.3)
                  & (cpu[0]["opacity"] > 0.5)).sum())
    log(f"  tiny split forward_multi (learned + relight light) in float64: "
        f"max |card - CPU| over comp_rgb_full, opacity, depth, "
        f"comp_rgb_phys_full of both lights = {worst:.2e}; ray_included "
        f"and stats equal: {same}; the lights differ by {lights:.3f}; "
        f"{glossy} glossy pixels take the third bounce; G1 launches "
        f"{launches}")
    if not (worst <= 1e-9 and same and launches > 0 and lights > 1e-3
            and glossy > 0):
        fail("card and CPU disagree on the tiny multi-light render")


def split_train_reference_phase(torch, gather, scatter):
    """One tiny split train step at stage 0 (step 5) and at stage 1 with
    the prefilter (step 30): card (G1, K1) against CPU (plain versions),
    both in float64 on the same params, rays and curvature directions;
    the loss and every parameter gradient."""
    from rise_sdf_tpu_torch import datasets, presets, systems

    cfg = presets.tiny_split_config()
    cfg["model"].update({"randomized": False, "visibility_prefilter": True})
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    for step in (5, 30):
        runs, batch = {}, None
        for dev in ("cpu", "cuda"):
            system = systems.make(cfg["system"]["name"], cfg, dm,
                                  save_dir=os.path.join("exp", "chip_smoke"),
                                  device=dev)
            # params drawn on the CPU, then moved off the sphere init so
            # that the table gradient is not zero
            system.init_state(0)
            gen = torch.Generator().manual_seed(3)
            with torch.no_grad():
                for p in system.model.parameters():
                    p.add_(0.05 * torch.randn(p.shape, generator=gen).to(dev))
            system.model.double()
            if batch is None:
                batch = system.sample_batch(torch.Generator().manual_seed(4),
                                            system.device_data(dm.train()))
                dirs = torch.rand((system.capacity, 3), dtype=torch.float64,
                                  generator=torch.Generator().manual_seed(5))
            grid = torch.ones(system.model.grid_resolution ** 3,
                              dtype=torch.bool, device=dev)
            before = (gather.gather_rows.launches,
                      scatter.scatter_add.launches)
            loss, _ = system.forward_loss(
                {k: (v.double() if v.is_floating_point() else v).to(dev)
                 for k, v in batch.items()}, grid, step,
                laplace_dirs=dirs.to(dev), **system.train_options(step))
            loss.backward()
            launches = (gather.gather_rows.launches - before[0],
                        scatter.scatter_add.launches - before[1])
            runs[dev] = (float(loss.detach()),
                         {k: p.grad.detach().cpu()
                          for k, p in system.model.named_parameters()
                          if p.grad is not None}, launches)
        (l_cpu, g_cpu, _), (l_gpu, g_gpu, launches) = runs["cpu"], \
            runs["cuda"]
        if sorted(g_cpu) != sorted(g_gpu):
            fail(f"step {step}: card and CPU differ in which parameters "
                 "take a gradient")
        worst = 0.0
        for k in g_cpu:
            scale = float(g_cpu[k].abs().max())
            if scale == 0:
                fail(f"zero gradient for {k} at step {step}")
            worst = max(worst,
                        float((g_gpu[k] - g_cpu[k]).abs().max()) / scale)
        log(f"  tiny split train step {step} in float64: loss cpu "
            f"{l_cpu:.12f} cuda {l_gpu:.12f}; worst gradient difference "
            f"{worst:.2e} of its tensor's largest entry; {len(g_cpu)} "
            f"gradients; card launches G1 {launches[0]}, K1 {launches[1]}")
        if not abs(l_gpu - l_cpu) <= 1e-9 * abs(l_cpu) or not worst <= 1e-5:
            fail(f"card and CPU disagree on the tiny split train step "
                 f"{step}")
        if launches[0] == 0 or launches[1] == 0:
            fail(f"the tiny split train step {step} launched G1 "
                 f"{launches[0]}, K1 {launches[1]} times")


def render_phase(torch, gather, scatter):
    """The flagship render through its entry point, at 800x800.  The
    hash encode of the band samples of chunk ``RENDER_CHUNK`` of the
    timed image (call 0 is the warm-up chunk) is recorded: its table and
    its ``[N, 16, 8]`` rows (the eval encode gathers every level and
    masks the closed ones after)."""
    from rise_sdf_tpu_torch import bench, presets
    from rise_sdf_tpu_torch.ops import hashgrid

    mcfg = presets.split_mixed_occ_full()["model"]
    band_slots = int(mcfg["ray_chunk"]) \
        * int(mcfg["eval_banded_samples_per_ray"]) \
        + int(mcfg["eval_band_reserve"])
    lookup = hashgrid.table_grad_lookup
    seen = {"calls": 0}

    def recording_lookup(table, rows):
        if rows.shape[0] == band_slots:
            if seen["calls"] == 1 + RENDER_CHUNK:
                seen.update(table=table.detach(), rows=rows.clone())
            seen["calls"] += 1
        return lookup(table, rows)

    hashgrid.table_grad_lookup = recording_lookup
    gather.gather_rows.launches = 0
    scatter.scatter_add.launches = 0
    try:
        res = bench.run("full", "cuda", profile_chunks=8,
                        log=lambda msg: log(f"  {msg}"))
    finally:
        hashgrid.table_grad_lookup = lookup
    g1, k1 = gather.gather_rows.launches, scatter.scatter_add.launches
    img = res.pop("image")
    res.pop("included")
    log(f"  bench: {json.dumps(res)}")
    log(f"  prefilter bank {res['prefilter_bank_s']:.2f} s, mip build "
        f"{res['mip_build_s'] * 1e3:.1f} ms, bake {res['bake_s'] * 1e3:.1f} "
        f"ms, render {res['render_s']:.3f} s: {res['rays_per_s']:.0f} "
        f"rays/s, {res['dropped_rays']} rays dropped "
        f"({res.get('dropped_rays_zero_padded')} counted as the JAX bench "
        f"counts, last chunk padded with zero rays); peak device memory "
        f"{res['peak_memory_gib']:.2f} GiB")
    log(f"  G1 launches {g1}, K1 launches {k1} (the whole run); G1 "
        f"{res['g1_device_ms']:.2f} of {res['profile_device_ms']:.2f} ms of "
        f"device time over {res['profile_chunks']} chunks "
        f"(share {res['g1_share']}), device busy "
        f"{res['device_busy_share']}")
    if tuple(img.shape) != (800, 800, 3) or not bool(
            torch.isfinite(img).all()):
        fail("the 800x800 render is not a finite 800x800x3 image")
    if g1 == 0 or res["g1_launches"] == 0:
        fail("G1 never launched during the render")
    if k1 != 0:
        fail(f"K1 launched {k1} times during the render")
    if "rows" not in seen:
        fail(f"no band-sample encode at chunk {RENDER_CHUNK} "
             f"({seen['calls']} recorded)")
    rows = seen["rows"]
    what = (f"render stream (chunk {RENDER_CHUNK}'s band-sample encode, "
            f"rows {list(rows.shape)})")
    log_runs(torch, rows, what)
    stream = check_gather(torch, gather, seen["table"], rows.reshape(-1),
                          what)
    return g1, stream, {"render_rows": rows.cpu(),
                        "render_table": seen["table"].cpu()}


def slice_phase(torch, scatter, steps, cfg, device="cuda"):
    from rise_sdf_tpu_torch import datasets, measure, systems
    from rise_sdf_tpu_torch.ops import hashgrid
    from rise_sdf_tpu_torch.ops.gather import gather_rows

    seed = int(cfg.get("seed", 42))
    t0 = time.perf_counter()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    save_dir = os.path.join("exp", "chip_smoke")
    system = systems.make(cfg["system"]["name"], cfg, dm, save_dir=save_dir,
                          device=device)
    state = system.init_state(seed)
    log(f"  system built in {time.perf_counter() - t0:.1f} s "
        f"(capacity {system.capacity}, {system.train_num_rays} rays/step)")

    # steps 0 and 1: record the encode's gathered rows so that the
    # cotangent reaching TableGradLookup can be read back after backward
    # (at step 0 it is exactly zero, since the sphere-init first layer
    # reads xyz only; step 1 is the first with a nonzero one)
    lookup = hashgrid.table_grad_lookup
    seen = {}

    def recording_lookup(table, rows):
        vals = lookup(table, rows)
        if vals.requires_grad:
            vals.retain_grad()
            seen.update(rows=rows, vals=vals)
        return vals

    table = system.model.geometry.encoding.encoding.table
    stream = {}

    def on_log(step, m):
        if step <= 1:
            if step == 1:
                hashgrid.table_grad_lookup = lookup
            rows, cot = seen.pop("rows"), seen.pop("vals").grad
            idx = rows.reshape(-1)
            vals = cot.reshape(-1, F).contiguous()
            got = table.grad.reshape(-1, F)
            check_scatter(torch, got, idx, vals, got.shape[0],
                          f"step {step} table gradient (K1) vs plain scatter")
            plain = scatter.scatter_add_plain(idx, vals, got.shape[0])
            log(f"  step {step}: max |cotangent| = "
                f"{float(vals.abs().max()):.3e}, max |K1 - float32 plain| = "
                f"{float((plain - got).abs().max()):.3e}")
            if step == 1:  # the training stream, timed after the slice
                # (held on the host, so the peak memory stays the step's)
                stream.update(rows=rows.cpu(), vals=vals.cpu(),
                              table=table.detach().reshape(-1, F).cpu())
        if step % 20 == 0 or step == steps - 1:
            log(f"  step {step}: loss {m['loss']:.5f} mse {m['rgb_mse']:.5f} "
                f"inv_s {m['inv_s']:.2f} rays {int(m['num_rays'])} "
                f"live samples {int(m['num_samples'])}")

    hashgrid.table_grad_lookup = recording_lookup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scatter.scatter_add.launches = 0
    gather_rows.launches = 0
    t_fit = time.perf_counter()
    state, metrics, sps, per_step = measure.train(system, steps, seed, state,
                                                  on_log)
    fit_s = time.perf_counter() - t_fit
    peak = torch.cuda.max_memory_allocated()
    t_val = time.perf_counter()
    res = system.validate(state, n_images=1)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t_val
    launches = scatter.scatter_add.launches
    g1 = gather_rows.launches
    hashgrid.table_grad_lookup = lookup

    losses = [m["loss"] for m in metrics]
    window = min(measure.RATE_WINDOW, steps - 1)
    live = [m["num_samples"] for m in metrics]
    log(f"  {steps} steps in {fit_s:.1f} s; {sps:.3f} steps/s over the last "
        f"{window} steps; live samples/step mean {np.mean(live):.0f} "
        f"(last {live[-1]:.0f}, buffer {system.capacity}); rays kept "
        f"{metrics[-1]['num_rays']:.0f}/{system.train_num_rays}")
    log(f"  peak device memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    w, h = cfg["dataset"]["img_wh"]
    log(f"  validate 1 view {w}x{h} in {val_s:.1f} s: "
        f"PSNR {res['psnr']:.3f} dB")
    log(f"  K1 launches during the slice: {launches}, G1 launches {g1}; "
        f"skipped updates {system.skipped_updates}")
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        fail("non-finite or missing losses")
    if state["step"] != steps or system.skipped_updates:
        fail(f"{system.skipped_updates} skipped updates")
    if not all(bool(torch.isfinite(p).all())
               for p in system.model.parameters()):
        fail("non-finite parameters after training")
    if launches < steps:
        fail(f"K1 launched {launches} times in {steps} steps")
    if g1 < steps:
        fail(f"G1 launched {g1} times in {steps} steps")
    if not (np.isfinite(res["psnr"]) and res["psnr"] > 5.0):
        fail(f"validation PSNR {res['psnr']}")
    shutil.rmtree(save_dir, ignore_errors=True)  # the 64 MiB checkpoint
    if per_step:
        first = measure.PROFILE_FROM + 1
        log(f"  profiled steps {first}-{first + per_step['steps'] - 1} "
            f"(torch.profiler), per step: wall {per_step['wall_ms']:.2f} ms, "
            f"device {per_step['device_ms']:.2f} ms; K1 "
            f"{per_step['k1_ms']:.3f} ms in {per_step['k1_launches']:g} "
            f"launches; G1 {per_step['g1_ms']:.3f} ms in "
            f"{per_step['g1_launches']:g} launches")
        for k, t, c in per_step["top"]:
            log(f"    {t:8.3f} ms/step  {c:5g}x  {k}")
    del system, state
    torch.cuda.empty_cache()
    k1, g1 = train_stream_phase(torch, scatter, stream)
    return launches, k1, g1, per_step, {
        f"train_{k}": v for k, v in stream.items()}


def log_runs(torch, rows, what, walk=32):
    """The atomics K1 issues on ``[N, L, K]`` rows (K = 8 corners, or the
    32-point probe neighbourhood) when it adds up runs of equal rows down
    each column in walks of ``walk`` samples, per level, and the share of
    x-neighbour cell corners (c, c + 4) that fall in one 32-byte sector
    of the table."""
    n, lv, k = rows.shape
    r = rows.reshape(n, -1)
    head = torch.ones_like(r, dtype=torch.bool)
    head[1:] = r[1:] != r[:-1]
    head[::walk] = True
    per_level = head.view(n, lv, k).sum((0, 2)).tolist()
    pair = (rows[..., 0:4] // 4 == rows[..., 4:8] // 4).float().mean()
    log(f"  {what}: {int(head.sum())} runs of {r.numel()} entries down "
        f"the columns in walks of {walk} (per level: "
        f"{[round(x / (n * k), 3) for x in per_level]} of the entries); "
        f"x-pairs in one sector {float(pair):.3f}")


def train_stream_phase(torch, scatter, stream):
    """K1 and G1 on the training stream recorded at step 1: the encode's
    ``[N, 16, 8]`` rows, their cotangent and the live table."""
    from rise_sdf_tpu_torch.ops import gather

    rows, vals, table = (stream[k].cuda() for k in ("rows", "vals", "table"))
    idx = rows.reshape(-1)
    what = f"train stream (step 1, rows {list(rows.shape)})"
    log_runs(torch, rows, what)
    k1 = check_time_scatter(torch, scatter, idx, vals, table.shape[0], what,
                            rows.shape[-2] * rows.shape[-1])
    g1 = check_gather(torch, gather, table, idx, what)
    return k1, g1


def flagship_phase(torch, scatter, gather, steps):
    """The flagship's training at full width in its two windows (see the
    module docstring, phase 8), then validation of one view; the table
    gradient of stage-1 step 13009 against the plain scatter of every
    encode's recorded cotangent; K1 and G1 on that step's probe stream.
    Returns K1's and G1's records of the probe stream, the profile and
    their launches in the phase."""
    from rise_sdf_tpu_torch import datasets, measure, systems
    from rise_sdf_tpu_torch.ops import hashgrid
    from rise_sdf_tpu_torch.presets import split_mixed_occ_train_full

    cfg = split_mixed_occ_train_full()
    seed = int(cfg["seed"])
    t0 = time.perf_counter()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    save_dir = os.path.join("exp", "chip_smoke_split")
    system = systems.make(cfg["system"]["name"], cfg, dm, save_dir=save_dir,
                          device="cuda")
    log(f"  system built in {time.perf_counter() - t0:.1f} s (capacity "
        f"{system.capacity}, prefiltered {system.capacity_prefiltered}, "
        f"{system.train_num_rays} rays/step)")
    table = system.model.geometry.encoding.encoding.table
    recorded = measure.SPLIT_PROFILE_FROM
    lookup = hashgrid.table_grad_lookup
    seen, per_step, stream = {"on": False, "enc": []}, [], {}

    def recording_lookup(tb, rows):
        vals = lookup(tb, rows)
        if seen["on"] and vals.requires_grad:
            vals.retain_grad()
            seen["enc"].append((rows, vals))
        return vals

    def on_log(step, m):
        per_step.append((step, scatter.scatter_add.launches,
                         gather.gather_rows.launches))
        if step == recorded:
            seen["on"] = False
            check_recorded_step(torch, scatter, table, seen.pop("enc"),
                                stream)
            seen["enc"] = []
        seen["on"] = step == recorded - 1
        if step % 4 == 0 or step in (recorded, measure.SPLIT_STAGE1_STEP
                                     + steps - 1):
            phys = f" phys {m['rgb_phys_mse']:.5f}" if "rgb_phys_mse" in m \
                else ""
            log(f"  step {step}: loss {m['loss']:.5f} mse "
                f"{m['rgb_mse']:.5f}{phys} curvature {m['curvature']:.5f} "
                f"rays {int(m['num_rays'])} live samples "
                f"{int(m['num_samples'])}")

    hashgrid.table_grad_lookup = recording_lookup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scatter.scatter_add.launches = 0
    gather.gather_rows.launches = 0
    t_fit = time.perf_counter()
    try:
        state, windows, prof = measure.train_split(system, steps, seed,
                                                   on_log)
    finally:
        hashgrid.table_grad_lookup = lookup
    fit_s = time.perf_counter() - t_fit
    peak = torch.cuda.max_memory_allocated()
    t_val = time.perf_counter()
    res = system.validate(state, n_images=1)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t_val
    k1, g1 = scatter.scatter_add.launches, gather.gather_rows.launches
    shutil.rmtree(save_dir, ignore_errors=True)

    # launches per step: the counts' growth from one step's end to the
    # next (a window's first step counts from the previous window's end)
    last, short = (0, 0), []
    for step, k, g in per_step:
        if k - last[0] < 1 or g - last[1] < 1:
            short.append((step, k - last[0], g - last[1]))
        last = (k, g)
    for stage in (0, 1):
        metrics, rate = windows[stage]
        live = [m["num_samples"] for m in metrics]
        log(f"  stage {stage}: {len(metrics)} steps, {rate:.3f} steps/s "
            f"over its steady steps; live samples/step mean "
            f"{np.mean(live):.0f}; rays kept {metrics[-1]['num_rays']:.0f}"
            f"/{system.train_num_rays}")
    log(f"  {2 * steps} steps in {fit_s:.1f} s; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(f"  validate 1 view 800x800 in {val_s:.1f} s: PSNR "
        f"{res['psnr']:.3f} dB, phys PSNR {res.get('phys_psnr', 0):.3f} dB, "
        f"{res['dropped_rays']} rays dropped")
    log(f"  K1 launches {k1}, G1 launches {g1} (both windows and the "
        f"validation); skipped updates {system.skipped_updates}")
    if prof:
        log(f"  profiled stage-1 steps (torch.profiler), per step: wall "
            f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms; "
            f"K1 {prof['k1_ms']:.3f} ms in {prof['k1_launches']:g} "
            f"launches; G1 {prof['g1_ms']:.3f} ms in "
            f"{prof['g1_launches']:g} launches")
        for k, t, c in prof["top"]:
            log(f"    {t:8.3f} ms/step  {c:5g}x  {k}")
    losses = [m["loss"] for w in windows.values() for m in w[0]]
    if len(losses) != 2 * steps or not np.all(np.isfinite(losses)):
        fail("non-finite or missing flagship losses")
    if system.skipped_updates:
        fail(f"{system.skipped_updates} skipped flagship updates")
    if short:
        fail(f"steps without a K1 or G1 launch (step, K1, G1): {short}")
    if not all(bool(torch.isfinite(p).all())
               for p in system.model.parameters()):
        fail("non-finite parameters after flagship training")
    if not (np.isfinite(res["psnr"]) and np.isfinite(res.get(
            "phys_psnr", np.nan))):
        fail(f"flagship validation {res}")
    if res["dropped_rays"]:
        fail(f"flagship validation dropped {res['dropped_rays']} rays")
    if "rows" not in stream:
        fail(f"no probe stream recorded at step {recorded}")
    torch.cuda.empty_cache()
    rows, vals = stream["rows"].cuda(), stream["vals"].cuda()
    idx = rows.reshape(-1)
    what = f"probe stream (step {recorded}, rows {list(rows.shape)})"
    log_runs(torch, rows, what)
    k1_rec = check_time_scatter(torch, scatter, idx, vals,
                                stream["table"].shape[0], what,
                                rows.shape[-2] * rows.shape[-1])
    g1_rec = check_gather(torch, gather, stream["table"].cuda(), idx, what)
    return k1_rec, g1_rec, prof, (k1, g1), (system, state)


def test_protocol_phase(torch, gather, scatter, system, state, views):
    """The test protocol on the flagship's stage-1 state (module
    docstring, phase 9).  Returns G1's launches in the phase, the two
    modes' seconds per view and G1's launches per multi-emitter view."""
    from rise_sdf_tpu_torch import measure

    torch.cuda.synchronize()
    gather.gather_rows.launches = 0
    scatter.scatter_add.launches = 0
    t0 = time.perf_counter()
    res = measure.test_protocol(system, state, views=views, log=log)
    phase_s = time.perf_counter() - t0
    g1, k1 = gather.gather_rows.launches, scatter.scatter_add.launches
    shutil.rmtree(os.path.join("exp", "test_protocol"), ignore_errors=True)
    multi, single = res["multi"], res["single"]
    for name, run in (("multi-emitter", multi), ("single-light", single)):
        log(f"  {name}: {run['views']} views, {run['s_per_view']:.2f} "
            f"s/view ({run['render_s_per_view']:.2f} s/view rendering); "
            f"fractions {run['fractions']}; chunks rendered "
            f"{run['chunks']}; G1 launches {run['g1_launches']}, K1 "
            f"launches {run['k1_launches']}")
        log(f"    metrics {json.dumps(run['metrics'])}")
    log(f"  single-light view 0 vs multi-emitter view 0: max |difference| "
        f"{json.dumps(single['max_abs_diff'])}, share of pixels above 1e-4 "
        f"{json.dumps(single['share_above_1e-4'])}; metrics within "
        f"{single['max_metric_diff']:.2e}")
    log(f"  phase {phase_s:.1f} s; G1 launches {g1}, K1 launches {k1}")
    want = {"psnr", "phys_psnr", "phys_ssim", "albedo_psnr", "albedo_ssim",
            "roughness_psnr", "normal_mae", "dropped_rays"} | {
        f"relight_{m}_{light}" for m in ("psnr", "ssim")
        for light in ("warm", "bright")}
    for run in (multi, single):
        if set(run["metrics"]) != want or not all(
                np.isfinite(v) for v in run["metrics"].values()):
            fail(f"test protocol metrics {run['metrics']}")
        if run["metrics"]["dropped_rays"]:
            fail(f"the test protocol dropped {run['metrics']['dropped_rays']}"
                 " rays after escalation")
        if run["g1_launches"] == 0 or run["k1_launches"] != 0:
            fail(f"test protocol launched G1 {run['g1_launches']}, K1 "
                 f"{run['k1_launches']} times")
    if single["max_metric_diff"] > 1e-3:
        fail("the single-light metrics differ from the multi-emitter ones")
    if max(single["max_abs_diff"].values()) > 1e-4:
        fail("the single-light images differ from the multi-emitter ones")
    return g1, {"multi_s_per_view": multi["s_per_view"],
                "single_s_per_view": single["s_per_view"],
                "multi_launches_per_view": multi["g1_launches"]
                / multi["views"]}


def _same_state(torch, src, dst, src_state, dst_state):
    """Names of the training-state tensors of ``dst`` that are not
    bit-equal to ``src``'s: params, Adam's ``exp_avg``, ``exp_avg_sq``
    and ``step`` per parameter, the schedule's ``last_epoch``, ``occs``,
    ``occ_binary`` and ``step``."""
    bad = []
    dst_params = dict(dst.model.named_parameters())
    for name, p in src.model.named_parameters():
        q = dst_params[name]
        if not torch.equal(p, q):
            bad.append(name)
        a, b = src.optimizer.state[p], dst.optimizer.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            if not torch.equal(a[k].cpu(), b[k].cpu()):
                bad.append(f"{k}:{name}")
    if src.scheduler.last_epoch != dst.scheduler.last_epoch:
        bad.append("last_epoch")
    for k in ("occs", "occ_binary"):
        if not torch.equal(src_state[k], dst_state[k]):
            bad.append(k)
    if int(src_state["step"]) != int(dst_state["step"]):
        bad.append("step")
    return bad


def lifecycle_phase(torch, gather, scatter, trained, state, steps):
    """A flagship run's lifecycle on phase 8's trained system and its
    stage-1 state (module docstring, phase 10).  Returns K1's and G1's
    launches in the resumed run and G1's in the export."""
    from rise_sdf_tpu_torch import datasets, systems
    from rise_sdf_tpu_torch.presets import split_mixed_occ_test_full
    from rise_sdf_tpu_torch.utils.saving import load_ply

    root = os.path.join("exp", "chip_smoke_lifecycle")
    shutil.rmtree(root, ignore_errors=True)
    ckpt = os.path.join(root, "resume.ckpt.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained.save_checkpoint(state, ckpt)
    save_s = time.perf_counter() - t0
    log(f"  a. save_checkpoint (whole state) in {save_s:.2f} s, "
        f"{os.path.getsize(ckpt) / 1e6:.1f} MB")

    cfg = split_mixed_occ_test_full()
    cfg["trainer"]["save_every_n_steps"] = 16
    seed = int(cfg["seed"])
    t0 = time.perf_counter()
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=os.path.join(root, "save"),
                          ckpt_dir=os.path.join(root, "ckpt"), device="cuda")
    built_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = system.load_checkpoint(ckpt)
    torch.cuda.synchronize()
    bad = _same_state(torch, trained, system, state, loaded)
    log(f"  b. new system in {built_s:.1f} s, load_checkpoint in "
        f"{time.perf_counter() - t0:.2f} s at step {loaded['step']}: "
        f"{len(bad)} tensors differ from the saved state")
    if bad:
        fail(f"the loaded state differs from the saved one: {bad[:10]}")

    start = int(loaded["step"])
    per_step, vals = [], []
    validate = system.validate

    def validate_once(st, n_images=None):
        vals.append(validate(st, n_images))
        return vals[-1]

    def on_log(step, m):
        per_step.append((step, scatter.scatter_add.launches,
                         gather.gather_rows.launches, m["loss"]))

    system.validate = validate_once
    torch.cuda.synchronize()
    scatter.scatter_add.launches = 0
    gather.gather_rows.launches = 0
    t0 = time.perf_counter()
    final = system.fit(max_steps=start + steps, seed=seed, state=loaded,
                       log_every=1, val_every=32, on_log=on_log)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    k1, g1 = scatter.scatter_add.launches, gather.gather_rows.launches
    del system.validate
    last, short, deltas = (0, 0), [], []
    for step, k, g, _ in per_step:
        if k - last[0] < 1 or g - last[1] < 1:
            short.append((step, k - last[0], g - last[1]))
        deltas.append((k - last[0], g - last[1]))
        last = (k, g)
    # launches per step: the median step's (a step that validates or
    # sweeps the grid launches more)
    k1_step, g1_step = (float(np.median(d)) for d in zip(*deltas))
    saves = [s for s in range(start, start + steps) if s > 0 and s % 16 == 0]
    latest = os.path.join(system.ckpt_dir, "latest.ckpt.npz")
    log(f"  c. fit {start} -> {int(final['step'])} in {fit_s:.1f} s "
        f"(saves of latest.ckpt.npz after steps {saves}, validation "
        f"{vals}); K1 launches {k1}, G1 launches {g1} (per step, median: "
        f"{k1_step:g} and {g1_step:g}); skipped updates "
        f"{system.skipped_updates}")
    if len(per_step) != steps or not np.all(np.isfinite(
            [m for *_, m in per_step])):
        fail("non-finite or missing losses in the resumed run")
    if short:
        fail(f"resumed steps without a K1 or G1 launch (step, K1, G1): "
             f"{short}")
    if system.skipped_updates:
        fail(f"{system.skipped_updates} skipped updates in the resumed run")
    # the fresh-init field grows softer over these steps: at step 13,056
    # some rays need more samples than the 4x eval buffer holds, so the
    # dropped rays are reported here (phases 8 and 9 require none)
    checks = [s for s in range(start, start + steps) if s > 0 and s % 32 == 0]
    if not checks or len(vals) != len(checks) or not all(
            np.isfinite(v["psnr"]) and np.isfinite(v["phys_psnr"])
            for v in vals):
        fail(f"validation inside fit after steps {checks}: {vals}")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scatter.scatter_add.launches = 0
    gather.gather_rows.launches = 0
    times = {}
    t0 = time.perf_counter()
    mesh = system.export(final, times)
    export_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    g1_export, k1_export = (gather.gather_rows.launches,
                            scatter.scatter_add.launches)
    if mesh is None:
        fail("export found no surface")
    iso = cfg["model"]["geometry"]["isosurface"]
    ply = os.path.join(system.save_dir,
                       f"it{int(final['step'])}-mc{iso['resolution']}.ply")
    verts, faces = load_ply(ply)
    log(f"  d. export at {iso['resolution']}^3 in {export_s:.1f} s: "
        f"{len(verts)} vertices, {len(faces)} faces; grid eval "
        f"{times['grid']:.2f} s, marching {times['march']:.2f} s, "
        f"attributes {times['attributes']:.2f} s; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB; G1 launches {g1_export}, K1 launches "
        f"{k1_export}")
    if g1_export == 0 or k1_export != 0:
        fail(f"export launched G1 {g1_export}, K1 {k1_export} times")
    radius = float(cfg["model"]["radius"])
    if (len(verts), len(faces)) != (len(mesh["v_pos"]),
                                    len(mesh["t_pos_idx"])) \
            or not len(faces) or np.abs(verts).max() > radius \
            or faces.max() >= len(verts):
        fail("the exported PLY does not read back as the mesh")
    for k in ("albedo", "metallic", "roughness"):
        a = np.load(os.path.join(system.save_dir, f"{k}.npy"))
        if len(a) != len(verts) or not np.isfinite(a).all() \
                or a.min() < 0 or a.max() > 1:
            fail(f"{k}.npy: {a.shape}, range {a.min()}..{a.max()}")

    back = system.load_checkpoint(latest)
    want = saves[-1] + 1 if saves else None
    log(f"  latest.ckpt.npz loads back at step {back['step']} "
        f"(expected {want})")
    if back["step"] != want:
        fail("latest.ckpt.npz is not the state after the last save")
    del system, trained, final, back, mesh
    torch.cuda.empty_cache()

    exp_dir = os.path.join(root, "cli")
    cmd = [sys.executable, "-m", "rise_sdf_tpu_torch.launch", "--preset",
           "split_mixed_occ_test_full", "--test", "--resume", ckpt,
           "dataset.n_images=1", "--exp_dir", exp_dir]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    for line in res.stdout.splitlines()[-6:]:
        log(f"    | {line}")
    trials = [os.path.join(dp, "save") for dp, dirs, _ in os.walk(exp_dir)
              if "save" in dirs]
    pngs = plys = []
    if trials:
        found = [os.path.join(dp, f) for dp, _, fs in os.walk(trials[0])
                 for f in fs]
        pngs = [f for f in found if f.endswith(".png")]
        plys = [f for f in found if f.endswith(".ply")]
    log(f"  e. {' '.join(cmd[1:])}: exit {res.returncode} in {cli_s:.1f} s;"
        f" {len(pngs)} PNGs, PLY {[os.path.basename(f) for f in plys]}")
    if res.returncode != 0:
        print(res.stderr[-4000:], file=sys.stderr, flush=True)
        fail("the launch CLI failed")
    if not pngs or len(plys) != 1:
        fail("the launch CLI left no test PNGs or no PLY")
    shutil.rmtree(root, ignore_errors=True)
    return {"k1": k1, "g1": g1, "g1_export": g1_export,
            "k1_per_step": k1_step, "g1_per_step": g1_step}


def check_recorded_step(torch, scatter, table, encodes, stream):
    """The step's table gradient (the sum of its encodes' K1 launches)
    against the float64 plain scatter of every encode's rows and
    cotangent; keeps the shared-probe encode's ``[N, L, 32]`` rows, its
    cotangent and the table (the probe stream)."""
    if not encodes:
        fail("no encode was recorded")
    got = table.grad.reshape(-1, F)
    ref = torch.zeros(got.shape, dtype=torch.float64, device=got.device)
    mag = torch.zeros_like(ref)
    shapes = []
    for rows, vals in encodes:
        if vals.grad is None:
            continue
        idx = rows.reshape(-1).long()
        v = vals.grad.reshape(-1, F).double()
        ref.index_add_(0, idx, v)
        mag.index_add_(0, idx, v.abs())
        shapes.append(list(rows.shape))
        if rows.shape[-1] == 32:
            stream.update(rows=rows.cpu(), vals=vals.grad.reshape(
                -1, F).contiguous().cpu(),
                table=table.detach().reshape(-1, F).cpu())
    err = (got.double() - ref).abs()
    bad = int((err > 1e-5 * mag + 1e-7).sum())
    log(f"  step table gradient vs the float64 plain scatter of {len(shapes)}"
        f" encodes {shapes}: max |K1 - ref64| = {float(err.max()):.3e}, "
        f"entries over bound = {bad}, max |ref| = "
        f"{float(ref.abs().max()):.3e}")
    if bad or not bool(torch.isfinite(got).all()):
        fail("the flagship step's table gradient disagrees with the plain "
             "scatter")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--split-steps", type=int, default=32,
                    help="steps in each of the flagship's two windows")
    ap.add_argument("--test-views", type=int, default=4,
                    help="test views of the test protocol's multi-emitter "
                         "run")
    ap.add_argument("--resume-steps", type=int, default=32,
                    help="steps of the resumed run in the lifecycle phase")
    ap.add_argument("--save-streams", metavar="FILE",
                    help="save the recorded streams (torch.save) for "
                         "python -m rise_sdf_tpu_torch.kernel_ab")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from rise_sdf_tpu_torch.ops import cuda_build, gather, scatter

    log("build K1 and G1:")
    t0 = time.perf_counter()
    cuda_build.build_libraries(["scatter_add", "gather_rows"])
    scatter._lib()
    gather._lib()
    log(f"  built and loaded in {time.perf_counter() - t0:.1f} s")
    for name in ("scatter_add", "gather_rows"):
        for line in cuda_build.build_logs.get(name, "").splitlines():
            log(f"  nvcc {name}: {line}")
    log("K1 vs float64 index_add_:")
    k1, s1 = kernel_phase(torch, scatter)
    log("G1 vs index_select:")
    g1 = gather_phase(torch, gather)
    log("small-input reference (card vs CPU):")
    small_reference_phase(torch)
    render_reference_phase(torch, gather)
    split_train_reference_phase(torch, gather, scatter)
    log("render slice: rise_sdf_tpu_torch.bench, split_mixed_occ_full, "
        "800x800:")
    g1["launches"], g1["render_stream"], streams = render_phase(
        torch, gather, scatter)
    from rise_sdf_tpu_torch.presets import neus_sphere_full

    log(f"training slice: NeuS neus_sphere_full, {args.steps} steps + 1 "
        f"view:")
    (k1["launches"], k1["train_stream"], g1["train_stream"], per_step,
     train) = slice_phase(torch, scatter, args.steps, neus_sphere_full())
    if args.save_streams:
        torch.save({**streams, **train}, args.save_streams)
    del streams, train
    log(f"flagship training: split-occ split_mixed_occ_train_full, "
        f"{args.split_steps} steps at stage 0 and at stage 1 + 1 view:")
    (k1["probe_stream"], g1["probe_stream"], split_step,
     (k1["flagship_launches"], g1["flagship_launches"]),
     (system, state)) = flagship_phase(torch, scatter, gather,
                                       args.split_steps)
    log(f"test protocol: split_mixed_occ_test_full at step "
        f"{int(state['step'])}, {args.test_views} views x (learned, warm, "
        f"bright) + view 0 in single-light mode:")
    g1["test_launches"], g1["test_protocol"] = test_protocol_phase(
        torch, gather, scatter, system, state, args.test_views)
    log(f"lifecycle: split_mixed_occ_test_full from step "
        f"{int(state['step'])}: save, load, {args.resume_steps} resumed "
        f"steps, export, the launch CLI:")
    t0 = time.perf_counter()
    life = lifecycle_phase(torch, gather, scatter, system, state,
                           args.resume_steps)
    log(f"  phase {time.perf_counter() - t0:.1f} s")
    del system, state
    k1["resume_launches"] = life["k1"]
    g1["resume_launches"] = life["g1"]
    g1["export_launches"] = life["g1_export"]
    k1["resume_launches_per_step"] = life["k1_per_step"]
    g1["resume_launches_per_step"] = life["g1_per_step"]
    s1["launches"] = k1["launches"]
    for key, rec in (("k1", k1), ("g1", g1)):
        for name, prof in (("per_step", per_step),
                           ("flagship_per_step", split_step)):
            if prof:
                rec[name] = {"device_ms": prof[f"{key}_ms"],
                             "launches": prof[f"{key}_launches"]}

    log(card)
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = ("train_stream", "render_stream", "per_step", "probe_stream",
             "flagship_per_step", "flagship_launches", "test_launches",
             "test_protocol", "resume_launches", "resume_launches_per_step",
             "export_launches")
    log(json.dumps({"kernels": [
        {"name": "scatter_add (K1)", "route": "cuda", "source": SRC_K1,
         "replaces": REPLACES_K1, **{k: k1[k] for k in keys},
         **{k: k1[k] for k in extra if k in k1}},
        {"name": "gather_rows (G1)", "route": "cuda", "source": SRC_G1,
         "replaces": REPLACES_G1, **{k: g1[k] for k in keys},
         **{k: g1[k] for k in extra if k in g1}},
        {"name": "scatter_add at S1's shape (K1)", "route": "cuda",
         "source": SRC_K1, "replaces": REPLACES_S1,
         **{k: s1[k] for k in keys}},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
