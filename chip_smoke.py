#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--steps 120] [--split-steps 32]
                          [--test-views 1] [--resume-steps 32]
                          [--save-streams FILE]

Phases, each of which fails the run (non-zero exit) when it fails:

1. card: name and power limit from ``nvidia-smi``, torch and CUDA versions;
2. build the kernels K1 (``rise_sdf_tpu_torch/csrc/scatter_add.cu``),
   G1 (``csrc/gather_rows.cu``) and K2 (``csrc/scatter_add_sorted.cu``)
   with nvcc, one process per source, all at once;
3. K1 against a float64 ``index_add_`` reference at the JAX test shapes,
   at S1's shape (12,582,912 rows into 2^19 x 2) and at the main-path
   shape (16 levels x 2^19 x 2, 8,388,608 rows per level, walked with the
   encode's period 128), per entry ``|K1 - ref| <= 1e-5 * S + 1e-7``
   with ``S`` the sum of ``|v|`` landing on that entry; median-of-10
   times (each over 10 back-to-back calls) of K1, of its plain version
   and of ``index_add_``;
4. G1 bit-equal to ``index_select`` at S2/S3's shape (8,388,608 rows from
   2^19 x 2), at S4's (4,194,304 rows from 2^19 x w, w = 2, 8, 32, and
   float64 W = 2: the 16-byte path at q = 2, 8 and 1 vectors a row), at
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
   read just after: the image must be finite, G1 and E1 (the eval encode)
   must launch and K1 must not (the run includes the bench's
   sphere-traced row, checked in phase 16b); G1's 16-byte path (the
   baked-SDF sample) must launch, its launches in the timed image and
   its device ms over the profiled chunks are printed.  The band-sample
   hash encode of one chunk from the middle of the image is recorded
   where it enters E1, with the rows the torch chain would gather (the
   render stream), and the same chunk's baked-SDF rows, the visibility
   probe's and the secondary alpha's (the bake stream); G1 is held to
   and timed against ``index_select`` on their rows.  E1 is held to the
   chain on that chunk's encode (the bench's 4096 rays: 49,152 points)
   and on a bake chunk's (262,144 points), 16 levels each with the
   render step's mask closing 2: E1f's
   features equal to the chain's, E1b's position gradient within
   ``E1_GRAD_GAP`` (none) of autograd's through the chain;
   median-of-10 times of E1f, E1b, the chain's forward and its forward
   and position backward;
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
   views (1) under the learned light and the ``TEST_LIGHTS``
   environment (``warm``; the preset's ``bright`` is cut for time)
   in one geometry pass per chunk (``forward_multi``, the
   third bounce on); then view 0 again
   in single-light mode, one render per light
   (``rise_sdf_tpu_torch.measure.test_protocol``).  The counts are
   zeroed just before and read just after: G1 must launch and K1 must
   not (no table gradient at eval; G1's launches on its 16-byte path per
   multi-emitter view are printed); every metric is finite, no ray is
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
   just before and read just after: E1 (the eval encode) must launch and
   K1 must not; the vertex and face counts, the grid-eval, marching and
   attribute seconds and the peak device memory are printed, and the
   PLY must read back with the same counts and vertices inside [-r,
   r]^3, the albedo, metallic and roughness arrays finite in [0, 1]; then
   ``latest.ckpt.npz`` must load back at the step after its last save;
   (e) ``python -m rise_sdf_tpu_torch.launch --preset
   split_mixed_occ_test_full --test --resume <a's file>
   dataset.n_images=1 dataset.img_wh=[400,400]`` (the view cut from
   800x800 for time) as a subprocess: exit 0, the test PNGs and the
   PLY in the trial's ``save/``, the wall time printed;
11. data parallel (``rise_sdf_tpu_torch.measure.ddp_window``): the
   flagship at ``split_mixed_occ_train_full``, full width, from a fresh
   init at stage 1 (step 13000) for 16 steps (``measure.DDP_STEPS``) over
   ranks of ``torch.distributed``: NCCL with one rank per GPU (up to 4)
   when two or more are visible, else two gloo ranks sharing ``cuda:0``
   and then a world-size-1 NCCL window in this process.  Each rank's
   K1 and G1 counts are zeroed just before its ``fit`` and read just
   after: both must launch on every rank at every step, with no skipped
   update and finite losses; at step 13009 the all-reduced table
   gradient must lie within one float32 ulp (relative) of the float64
   mean of every rank's own at two ranks (at more, within the float32
   sum's bound, ``measure._check_reduced``); every rank's params and
   occupancy grid must be bit-equal after the window.  Then one
   validation view sharded over the ranks (finite PSNRs), whose images
   (colour, phys colour, opacity and depth) must be within 2e-3 of this
   process's one-process render of rank 0's checkpoint.  The backends,
   world sizes, steps/s per rank, all-reduce ms and MB per step, peak
   memory and launches per rank per step are printed.  With two or more
   GPUs, K1 and G1 are also held to their plain versions on ``cuda:1``;
12. a scene from disk: (a) the concave scene (``render_image_concave``)
   at 800x800 under the ``bright`` environment, written (by a worker
   process started after phase 1, as is 13a's capture, while the card
   runs phases 2-11) to a temporary directory in the TensoIR layout (4
   train views and 1 test view, each with ``metadata.json``,
   ``rgba.png``, ``rgba_warm.png``, ``rgba_bright.png``, ``albedo.exr``,
   ``roughness.exr`` and ``normal.exr`` with the mask as alpha; ``warm.hdr`` and
   ``bright.hdr`` as run-length RGBE at 2:1 lat-long) and in the Blender
   layout, by this script's own PNG writer (its rows cycle the five
   filters) and RGBE writer; (b) loaded through ``datasets.make
   ("tensoir" | "blender", ...)``: every PNG decodes to the bytes
   written (the decode ms per image and its extrapolation to a TensoIR
   scene's 1,300 PNGs are printed), every image, mask, relight image and
   material EXR equals what was written, the normals are within 1e-6 of
   the renderer's, each view's ``directions @ c2w`` within 1e-6 of the
   rays it was rendered with, and each ``.hdr`` within RGBE's
   quantization of the analytic environment clipped at 0 (per texel
   2^-7 of its largest channel); (c) ``split_mixed_occ_tensoir`` on the
   loaded scene (``relight_list`` warm and bright, ``hdr_filepath`` the
   scene's ``.hdr`` files) at full width: ``fit`` from a fresh init at
   stage 1 (step 13000) for 16 steps, K1 and G1 launching on every step
   with finite losses and no skipped update, then ``test`` on the one
   test view, where G1 launches and K1 does not and every metric,
   relight PSNR and SSIM of both lights among them, is finite (the
   dropped rays of the fresh init are printed, not required to be 0);
   (d) ``neus_blender`` on the Blender layout for 16 steps, K1 and G1 on
   every step, finite losses.  The counts are zeroed just before each
   part and read just after.  Cut from TensoIR's 100 train and 200 test
   views and 5 relight environments read from files to these 5 views
   and 2 analytic environments, and to 16 steps per window.

13. a real capture: (a) the concave scene (``render_image_concave``
   under ``env_radiance``) on a checkered floor disk of radius 3x its
   extent, with the environment seen at infinity around both, from 9
   cameras on a ring 2.5x its extent away, written at 1600x1064 to a
   temporary directory in COLMAP's layout (``images/NNN.png``,
   ``sparse/0/{cameras,images,points3D}.bin``: a PINHOLE camera,
   world-to-camera poses in COLMAP's convention and in a world frame
   that is a similarity of the scene's, object and floor hit points)
   by this script's own writers, and loaded through ``datasets.make
   ("colmap", ...)`` at ``img_downscale`` 2: every image bit-equal to
   ``resize_like_pil`` of what was written, the poses normalised with
   the floor's normal as +z (each camera's up row equal to the scene's,
   every camera at distance 1 and the scene's height, the floor points
   at one height with the object's above) and the 120 predict poses;
   (b) ``neus_colmap`` (``presets.neus_colmap``, the learned background
   on its own 16 x 2^19 x 2 hash grid) trained from a fresh init for 32
   steps: steps/s over the last 15, peak memory, no skipped update,
   and two K1 and two G1 launches on every step (the foreground's and
   the background's tables); step 1's background encode (``[4096 *
   255, 16, 8]`` rows, its cotangent and table: the background
   stream) is recorded and its table gradient held to the float64
   scatter; (c) K1 and G1 held to their references and timed on the
   background stream; (d) one step with ``lambda_distortion`` 0.01:
   the card's distortion term within 1e-4 (relative) of a float64
   per-ray double sum on the host over the same buffer; (e) the first
   test view (finite PSNR, dropped rays printed) and the first predict
   frame, G1 launching and K1 not.  The counts are zeroed just before
   (b) and (e) and read just after.  Cut from a capture's 100-300 views
   of ~5000 pixels loaded at ``img_downscale`` 4 to 9 views of 1600
   loaded at 2, and from 20,000 steps to 33.
14. what a user's capture or config names: (a) every JPEG fixture of
   ``tests/data/jpeg`` decoded by the port (``utils/jpeg.py``, built
   with g++) to bytes whose SHA-256 and shape equal Pillow's in the
   manifest; (b) phase 13's capture encoded by this script's numpy
   writer as baseline JPEG (4:2:0, quality 95, a restart marker after
   every MCU row) into a sibling directory with the same sparse model
   (``NNN.jpg``): every decode at least 35 dB from its PNG (the host's
   decode ms per image and its extrapolation by pixel count to a
   5000-wide image printed), the colmap loader at ``img_downscale`` 2
   giving ``resize_like_pil`` of each decode, then ``neus_colmap`` for
   16 steps from a fresh init: finite losses, none skipped, K1 twice
   and G1 two or three times per step; (c) ``neus_sphere_full`` with
   ``AdamW`` (weight decay 0.01), ``ChainedScheduler[ConstantLR(0.5, 4),
   ExponentialLR(0.999)]`` and variance modulation (from step 8 to
   2048 at step 64) for 24 steps, each step held to a float64 host
   recurrence: every group's lr, ``prev_inv_s`` (it tracks
   ``exp(10 variance)`` up to step 8, then AdamW decays it by ``1 - lr
   wd`` per step, as JAX's optax chain does) and ``inv_s`` under the
   cap; K1 once and G1 once or twice per step, none skipped; then the
   state saved and loaded, every tensor (``prev_inv_s`` and the AdamW
   state among them) bit-equal; (d) seeded synthetic VGG16-LPIPS
   weights in ``RISE_SDF_LPIPS_WEIGHTS``: LPIPS of phase 9's 800x800
   view-0 render and ground truth on the card within 1e-5 (relative) of
   the CPU's, its ms printed, then the test protocol on one view
   (phase 8's state) whose ``phys_lpips``, ``albedo_lpips`` and
   ``relight_lpips_{light}`` are finite, G1 launching and K1 not.
   The counts are zeroed just before each training window and test run
   and read just after.
15. the JAX package's remaining appearance library: (a) NeuS at
   ``neus_sphere_color_full`` (``neus_sphere_full`` with a
   ``volume-color`` head: the 48 geometry features through the radiance
   head's 4 x 128 MLP) from a fresh init for 16 steps, then ``validate``
   on one view: steps/s, peak memory, finite losses, no skipped update,
   one K1 and at least one G1 launch per step, E1 and no K1 in the
   validation; (b) ``volume-pbr`` with ``brdf-ggx`` on phase 9's view 0
   (640,000 shading points: positions and normals from its depth and
   normals, materials from a seed), the phase-8 emitter and
   ``compute_indirect`` wrapping the flagship's
   ``compute_indirect_radiance`` (no compaction, on the eval bake) and
   secondary head, in chunks of 64,000 points: finite, G1 launching;
   the CPU repeats one chunk on the same uniforms: its sampled
   directions within 1e-3 of the card's and within 1e-5 on all but 0.5 %
   of them (square roots near 0 amplify float32 rounding); then it
   shades the chunk from the card's directions, every output within
   2e-3 of max(1, its largest entry) (the flagship's bf16 heads); its
   shading from its own directions is printed beside it, unbounded (the
   environment and the GGX pdf turn ~1e-4 in a direction into up to
   ~1e-2 of radiance); (c) the learned
   light's ``update_pdf`` at 128 x 256 and 1,048,576 ``sample`` draws,
   card against CPU on the same uniforms: the CDFs within 1e-4
   (relative: the projection of the 512^2 base), the directions on the
   same state within 1e-5, the pdf within 1e-5 (relative) but for at
   most 1 in 10,000 draws on a texel edge, and the mean of 1/pdf within
   2 % of 4 pi; (d) every warp sampler, ``ray_resampling``,
   ``grid_sample_2d`` / ``_3d``, ``prepare_shading_normal``,
   ``xfm_points``, the eight image losses and two rendering drivers at
   one 800x800 view's size (640,000 points or rays; the drivers in eval
   chunks of 4096 rays), card against CPU in float64 within 1e-9 (the
   losses relative; in float32 these functions amplify rounding where
   they normalise short vectors or take square roots near 0); (e) the
   test GIFs that phases 9 and 14d wrote (``it{step}-test.gif``,
   ``it{step}-test-pbr.gif``) read back by the port's decoder: one
   frame per view, the first equal to its PNG quantised, the
   quantisation error printed.
16. the sphere-traced eval (``model.eval_mode: sphere_trace``): (a)
   ``forward_surface`` and ``forward_surface_multi`` (the learned light
   and a relight light with the third bounce) at the tiny split config,
   stage 1, variance 0.9, on 128 fan rays in float64, under full, shell
   and absent occupancy: card against CPU, masks and counts equal, every
   channel within 1e-6, misses the background within 1e-5, G1 launching
   and K1 not; (b) the bench's sphere row from phase 6's run (the 800x800
   headline scene rendered by ``forward_surface`` in chunks of 4096
   rays): rays/s, unresolved rays, G1 and E1 launches per image and the
   PSNR against phase 6's volumetric image printed; the image finite,
   misses the background within 1e-5, E1 launching and K1 not; (c) the test
   protocol of phase 9 with ``eval_mode: sphere_trace`` on phase 8's
   parameters made sharp as the bench's headline makes them (variance
   0.67, inv_s ~ 812, and the bench's solid occupancy grid: the stand-in
   for a converged field that sphere tracing is meant for), one test
   view at 400x400 (cut from 800x800 for time) in multi-emitter mode
   and then in single-light mode, phase
   9's bounds between the modes, every metric finite and no ray dropped
   after the volumetric residual; the residual rays, seconds per view
   and counts printed.  (On phase 8's soft state itself, inv_s ~ 20,
   the guard sends 620,369 of a view's 640,000 rays to the residual,
   whose 2x buffer drops 134,475 of them, as the JAX package's would,
   and the two modes take 389 s.)  The counts are zeroed
   just before (a) and (c) and read just after; (b) reads the bench's
   own count differences.
17. bit-reproducible training and the YAML configs (``CUBLAS_WORKSPACE_
   CONFIG`` is ``:4096:8`` for the whole run, as torch's deterministic
   mode asks): (a) K2 (``scatter_add_sorted``) on the training, probe
   and background streams recorded by phases 7, 8 and 13 (their
   cotangents, float32, 2 wide, at the encodes' periods 128, 96 and
   128) and on the two gather backwards of the training scan (4096 rays
   in a 1,048,576-slot buffer, float64, 1 wide): bit-equal across two
   launches and to its plain version (the same fixed-point arithmetic in
   torch ops), its passes run one by one bit-equal to it, per entry
   within 1e-6 of the sum of the magnitudes of a float64 sum, and timed
   (medians of CUDA events) whole and pass by pass (zero, range for
   float64, buckets, scatter, convert) beside its byte bound, K1 at the
   stream's period, ``index_add_`` and ``index_add_`` under
   ``torch.use_deterministic_algorithms(True)``; (b) under
   ``torch.use_deterministic_algorithms``: first two flagship steps at
   stage 0 under ``warn_only``; then ``neus_sphere_full`` trains
   ``NEUS_DET_STEPS`` steps twice from one seed and once resumed from a
   checkpoint at half way, and phase 8's flagship system
   ``SPLIT_DET_STEPS`` stage-1 steps from step 13,000 twice, each also
   twice in the default mode; the deterministic runs' states (params,
   Adam's moments and steps, the schedule, the occupancy grid) must be
   bit-equal, the default runs' largest difference is printed, with
   steps/s in both modes; every run zeroes the counts just before it and
   reads them just after: K2 and G1 must launch and K1 not under the
   switch, K1 and G1 and not K2 without it; the first deterministic run
   of each model runs under ``warn_only`` (the same algorithms), and
   neither it nor the stage-0 steps may draw a warning that names an op
   without a deterministic implementation; (c) ``python -m
   rise_sdf_tpu_torch.launch --config configs/split-smoke.yaml --train``
   (30 steps across the stage flip, test, export), and at full width for
   ``SCENE_STEPS`` steps and then test and export, ``--config
   configs/split-mixed-occ-tensoir.yaml`` on phase 12's scene in the
   TensoIR layout and ``--config configs/neus-blender.yaml`` on it in
   the Blender layout, each run in this process with the counts zeroed
   before and read after (K1 and G1 must launch, K2 not),
   ``config/parsed.yaml`` and ``raw.yaml`` written, and the two scene
   runs' ``parsed.yaml`` equal to the presets ``split_mixed_occ_tensoir``
   and ``neus_blender`` with the same dotlist (but for the two entries
   the yaml derives from ``trainer.max_steps``).

Phase 18 is hash-table row sharding (``system.table_shards``, JAX's
``model`` mesh axis): (a) K1, G1 and K2 on the training and probe
streams cut as shards 0 and 1 of 2 (a row outside the shard absent,
-1), each against its plain version (K1 to the float64 reference's
per-entry bound, G1 and K2 bit for bit) and timed, with a bound of the
bytes of every index, the present rows' values and the shard's table;
(b) the flagship at full width with ``table_shards: 2`` on two ranks
(gloo sharing the card, NCCL one card a rank with two or more;
data=1 x model=2) for ``TABLE_SHARD_STEPS`` stage-1 steps from a
one-process state ``SHARD_PRE_STEPS`` steps past step 13,000
(``measure.table_shard_window``): the first step's reduced gradients
against a one-process step on the same batch (the table as the shards'
rows joined) within ``SHARD_GRAD_TOL`` of each tensor's largest entry
or ``SHARD_SPREAD`` times the spread of ``SHARD_REFS`` one-process
steps, the
replicated parameters bit-equal on the ranks, K1's
and G1's launches per rank and step, the checkpoint written at tp=2
loaded into one process bit-equal to the ranks' gathered state,
``VAL_CHUNKS`` chunks of validation view 0 against the one-process
render within ``SHARD_RENDER_TOL``, and the export's vertex count (at
``EXPORT_RES``^3, cut from 512 for time) equal to the one-process
export's; (c) ``dryrun_multichip(4)`` on four gloo ranks sharing the
card, which takes data=2 x model=2.

``--save-streams FILE`` saves the recorded training, render and bake
streams for the same-call A/B against another tree, ``python -m
rise_sdf_tpu_torch.kernel_ab`` (``_ab/streams.pt``, about 1.8 GB, in the
gitignored ``_ab/``).
The last two lines are the kernels' JSON record (K1's and G1's entries
also carry their times on the recorded streams and per NeuS and flagship
train step, G1's its launches in the test protocol, both their launches
in phase 10's resumed run and G1's in its export, both their
launches per rank in phase 11, in the three parts of phase 12, in
phase 13's training and renders, with their times on its background
stream, in phase 14's two training windows and test run, and in phase
15's NeuS training, its validation and the ``volume-pbr`` run, and in
phase 16's three parts; K2's entry carries its times on each stream of
17a and its launches in each run of 17b; all three carry their records
on 18a's shard streams and K1's and G1's their launches per rank in
18b; G1's ``rows16`` its 16-byte path's records: S4's shapes, the
bake stream, launches per render and per test view; E1's entry its
check and times on the render and bake streams of phase 6 and its
launches in the timed image, the export, 15a's validation and 16b's
sphere row) and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

import argparse
import atexit
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SRC_K1 = "rise_sdf_tpu_torch/csrc/scatter_add.cu"
SRC_G1 = "rise_sdf_tpu_torch/csrc/gather_rows.cu"
SRC_K2 = "rise_sdf_tpu_torch/csrc/scatter_add_sorted.cu"
SRC_E1 = "rise_sdf_tpu_torch/csrc/hashgrid_eval.cu"
REPLACES_K1 = "rise_sdf_tpu/ops/scatter_pallas.py:49"
REPLACES_S1 = "scripts/scatter_kernel_bench.py:33"
# K2 replaces no Pallas kernel: the counterpart of the XLA ops of the
# sorted table gradient
REPLACES_K2 = "rise_sdf_tpu/ops/hashgrid.py:448 (_encode_sorted_vjp)"
REPLACES_G1 = ("scripts/pallas_gather_bench.py:79 (S2), "
               "scripts/pallas_gather_bench.py:128 (S3), "
               "scripts/r5_gather_width_bench.py:52 (S4)")
# E1 replaces no Pallas kernel: the counterpart of the XLA ops of the
# plain encode and autograd's position gradient through it
REPLACES_E1 = "rise_sdf_tpu/ops/hashgrid.py:277 (_encode_plain)"
F = 2
# the relight lights of phases 9 and 16c's test protocols: one of the
# preset's two (cut for time: each light is a full render in
# single-light mode)
TEST_LIGHTS = ("warm",)
# the render chunk whose hash encode is recorded (of 157)
RENDER_CHUNK = 78
# the bake's points a chunk (``ops/sdf_bake.py``)
BAKE_CHUNK = 1 << 18
# the largest gap of E1b's position gradient to the chain's, as a share
# of the largest |gradient|: none (bit-equal)
E1_GRAD_GAP = 0.0
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


def gather_bound_ms(m, w, rows, elem=4):
    """Least time of ``table[idx]``: idx read once, each of the ``rows``
    distinct table rows it names read once, the output written once (a
    gather does no arithmetic); ``elem`` bytes per table entry."""
    return (m * 4 + (rows + m) * w * elem) / HBM_BYTES_PER_S * 1e3


def eval_encode_bound_ms(n, width, rows):
    """Least times of E1f and E1b on ``n`` points with ``width`` feature
    columns: x read once (12 B a point), the features written or the
    cotangent read once, E1b's gradient written once (12 B a point), and
    each of the ``rows`` distinct 8-byte table rows read once."""
    feats = n * 12 + n * width * 4 + rows * 8
    grad = n * 12 + n * width * 4 + n * 12 + rows * 8
    return feats / HBM_BYTES_PER_S * 1e3, grad / HBM_BYTES_PER_S * 1e3


def check_eval_encode(torch, enc, x, step, levels, what):
    """E1f equal to the chain's features and E1b to autograd's position
    gradient through the chain (within ``E1_GRAD_GAP``) on the card
    tensors of one eval encode; median-of-10 times of E1f, E1b, the
    chain's forward (under ``no_grad``) and the chain's forward and
    position backward (what the analytic eval ran before E1)."""
    from rise_sdf_tpu_torch.measure import median_ms
    from rise_sdf_tpu_torch.ops import hashgrid_eval

    table, lo, hi = enc.table.detach(), levels.lo, levels.hi
    n, width = x.shape[0], enc.n_output_dims
    gen = torch.Generator(device="cuda").manual_seed(2)
    cot = torch.randn((n, width), generator=gen, device="cuda")
    with torch.no_grad():
        want = enc._chain(x, step, lo, hi)
    got = hashgrid_eval.encode_features(x, table, levels)
    equal = torch.equal(got, want)
    del got, want
    xg = x.detach().requires_grad_(True)
    want, = torch.autograd.grad(enc._chain(xg, step, lo, hi), xg, cot)
    got = hashgrid_eval.encode_position_grad(x, table, cot, levels)
    gap = float((got - want).abs().max())
    scale = float(want.abs().max())
    grad_equal = torch.equal(got, want)
    del got, want

    def chain_features():
        with torch.no_grad():
            return enc._chain(x, step, lo, hi)

    ms_f = median_ms(lambda: hashgrid_eval.encode_features(x, table, levels))
    ms_b = median_ms(lambda: hashgrid_eval.encode_position_grad(
        x, table, cot, levels))
    plain_f = median_ms(chain_features)
    plain = median_ms(lambda: torch.autograd.grad(
        enc._chain(xg, step, lo, hi), xg, cot))
    rows = int(torch.unique(chain_rows(torch, enc, x, levels)).numel())
    bound_f, bound_b = eval_encode_bound_ms(n, width, rows)
    open_levels = int(sum(levels.mask[lo:hi]))
    log(f"  {what}: {n} points, levels [{lo}, {hi}) ({open_levels} open), "
        f"{rows} distinct rows: features equal {equal}, gradient "
        f"bit-equal {grad_equal} (max gap {gap:.3e} of max |grad| "
        f"{scale:.3e}); E1f {ms_f:.4f} ms (bound {bound_f:.4f}), E1b "
        f"{ms_b:.4f} ms (bound {bound_b:.4f}); the chain's forward "
        f"{plain_f:.4f} ms, forward and position backward {plain:.4f} ms "
        f"(bytes; median of 10)")
    if not equal:
        fail(f"E1f differs from the chain's features at {what}")
    if gap > E1_GRAD_GAP * scale:
        fail(f"E1b is {gap:.3e} off the chain's position gradient at {what}")
    return {"max_abs_err": gap, "ms": ms_f + ms_b, "features_ms": ms_f,
            "grad_ms": ms_b, "plain_ms": plain, "plain_features_ms": plain_f,
            "bound_ms": bound_f + bound_b, "features_bound_ms": bound_f,
            "grad_bound_ms": bound_b, "bound_by": "bytes",
            "library_ms": None, "points": n, "levels": [lo, hi],
            "open_levels": open_levels, "distinct_rows": rows}


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
    bound = gather_bound_ms(m, w, rows, table.element_size())
    log(f"  {what}: {m} rows ({rows} distinct) from {n} x {w} "
        f"{str(table.dtype)[6:]}: bit-equal "
        f"{equal}; G1 {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms (bytes; median of 10)")
    if not equal:
        fail(f"G1 differs from index_select at {what}")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": "bytes"}


def gather_phase(torch, gather):
    """G1 at S2/S3's, S4's, one render chunk's and the main path's
    shapes; returns the main path's record and those of the shapes on
    G1's 16-byte path (rows of 16-byte vectors)."""
    from rise_sdf_tpu_torch.measure import g1_shapes

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows16 = {}
    for what, (table, idx) in g1_shapes(gen):
        res = check_gather(torch, gather, table, idx, what)
        if table.shape[1] * table.element_size() != 8:
            rows16[what] = res
        del table, idx
    torch.cuda.empty_cache()
    return res, rows16


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


def e1_launches():
    """E1's launches so far (the eval encode: features and position
    gradient), where eval paths keep no graph through the encode."""
    from rise_sdf_tpu_torch.ops import hashgrid_eval

    return hashgrid_eval.encode_features.launches \
        + hashgrid_eval.encode_position_grad.launches


def chain_rows(torch, enc, x, levels):
    """The ``[N, L_open, 8]`` int32 rows of the flattened ``[L T, F]``
    table that the chain would gather for E1's encode of ``x`` over
    ``levels`` (``hashgrid_eval.Levels``)."""
    with torch.no_grad():
        flat = enc._corner_rows(enc._cell(x, levels.lo, levels.hi)[0],
                                levels.lo, levels.hi)
        offs = torch.arange(levels.lo, levels.hi, device=x.device)
        return (flat + offs[None, :, None] * enc.table_size).to(torch.int32)


@contextlib.contextmanager
def recording_bake(chunk):
    """Records the baked-SDF rows that the flagship model's forward call
    ``1 + chunk`` reads (call 0 is ``bench.run``'s warm-up chunk): the
    int32 row indices of each G1 gather of the visibility probe
    (``sdf_bake.sample_packed``, under ``"probe"``) and of the secondary
    pass's alpha (``sample_packed_grad``, under ``"alpha"``), as lists,
    and the packed table (``"table"``).  Yields that dict."""
    from rise_sdf_tpu_torch.models.split_mixed_occ import SplitMixedOccModel
    from rise_sdf_tpu_torch.ops import sdf_bake

    seen = {"forwards": 0, "chunk": None, "part": None, "probe": [],
            "alpha": []}
    forward, gather_rows = SplitMixedOccModel.forward, sdf_bake.gather_rows
    readers = {"probe": sdf_bake.sample_packed,
               "alpha": sdf_bake.sample_packed_grad}

    def recording_forward(self, *args, **kw):
        seen["chunk"] = seen["forwards"] - 1
        seen["forwards"] += 1
        return forward(self, *args, **kw)

    def reading(part):
        def read(*args, **kw):
            seen["part"] = part
            try:
                return readers[part](*args, **kw)
            finally:
                seen["part"] = None
        return read

    def recording_gather(table, idx):
        if seen["chunk"] == chunk and seen["part"]:
            seen["table"] = table
            seen[seen["part"]].append(idx.clone())
        return gather_rows(table, idx)

    SplitMixedOccModel.forward = recording_forward
    sdf_bake.sample_packed = reading("probe")
    sdf_bake.sample_packed_grad = reading("alpha")
    sdf_bake.gather_rows = recording_gather
    try:
        yield seen
    finally:
        SplitMixedOccModel.forward = forward
        sdf_bake.sample_packed = readers["probe"]
        sdf_bake.sample_packed_grad = readers["alpha"]
        sdf_bake.gather_rows = gather_rows


def render_phase(torch, gather, scatter):
    """The flagship render through its entry point, at 800x800.  The
    hash encode of the band samples of chunk ``RENDER_CHUNK`` of the
    timed image (call 0 is the warm-up chunk) is recorded where it
    enters the eval encode (E1): its points, its table and the ``[N,
    16, 8]`` rows the torch chain would gather (the eval encode takes
    every level and masks the closed ones after); so is the first bake
    chunk's encode, and the same render chunk's baked-SDF rows (the bake
    stream, ``recording_bake``), which G1's 16-byte path reads.  E1 is
    held to the chain and timed on both encodes."""
    from rise_sdf_tpu_torch import bench, presets
    from rise_sdf_tpu_torch.ops import hashgrid

    mcfg = presets.split_mixed_occ_full()["model"]
    band_slots = int(mcfg["ray_chunk"]) \
        * int(mcfg["eval_banded_samples_per_ray"]) \
        + int(mcfg["eval_band_reserve"])
    forward = hashgrid.HashGridEncoding.forward
    seen = {"calls": 0}

    def recording_forward(enc, x, step=None, levels=None, **kw):
        """The eval encodes of the render chunk and of a bake chunk, as
        E1 takes them."""
        if kw.get("eval_encode") and x.shape[0] in (band_slots, BAKE_CHUNK):
            lv = enc.eval_levels(*enc._level_range(levels, enc.n_levels),
                                 step)
            if x.shape[0] == BAKE_CHUNK and "bake" not in seen:
                seen["bake"] = (enc, x.clone(), step, lv)
            if x.shape[0] == band_slots:
                if seen["calls"] == 1 + RENDER_CHUNK:
                    seen["render"] = (enc, x.clone(), step, lv)
                    seen.update(table=enc.table.detach().reshape(
                        -1, enc.n_features_per_level),
                        rows=chain_rows(torch, enc, x, lv))
                seen["calls"] += 1
        return forward(enc, x, step, levels, **kw)

    hashgrid.HashGridEncoding.forward = recording_forward
    gather.gather_rows.launches = 0
    scatter.scatter_add.launches = 0
    try:
        with recording_bake(RENDER_CHUNK) as baked:
            res = bench.run("full", "cuda", profile_chunks=8,
                            log=lambda msg: log(f"  {msg}"))
    finally:
        hashgrid.HashGridEncoding.forward = forward
    g1, k1 = gather.gather_rows.launches, scatter.scatter_add.launches
    img = res.pop("image")
    res.pop("included")
    sphere = {"image": res.pop("sphere_image").reshape(img.shape),
              "opacity": res.pop("sphere_opacity").reshape(img.shape[:2]),
              "headline": img, **{k: res[k] for k in res
                                  if k.startswith("sphere_")}}
    log(f"  bench: {json.dumps(res)}")
    log(f"  prefilter bank {res['prefilter_bank_s']:.2f} s, mip build "
        f"{res['mip_build_s'] * 1e3:.1f} ms, bake {res['bake_s'] * 1e3:.1f} "
        f"ms, render {res['render_s']:.3f} s: {res['rays_per_s']:.0f} "
        f"rays/s, {res['dropped_rays']} rays dropped "
        f"({res.get('dropped_rays_zero_padded')} counted as the JAX bench "
        f"counts, last chunk padded with zero rays); peak device memory "
        f"{res['peak_memory_gib']:.2f} GiB")
    log(f"  G1 launches {g1}, K1 launches {k1} (the whole run), E1 "
        f"{res['e1_launches']} (the timed image); G1 "
        f"{res['g1_device_ms']:.2f} of {res['profile_device_ms']:.2f} ms of "
        f"device time over {res['profile_chunks']} chunks "
        f"(share {res['g1_share']}), device busy "
        f"{res['device_busy_share']}")
    rows16 = {"render_launches": res["g1_16_launches"],
              "render_chunks": res["n_chunks"],
              "profile_chunks": res["profile_chunks"],
              "profile_ms": res["g1_16_device_ms"],
              "profile_launches": res["g1_16_profile_launches"]}
    log(f"  G1's 16-byte path (the baked-SDF sample): "
        f"{rows16['render_launches']} launches in the timed image "
        f"({res['n_chunks']} chunks); {rows16['profile_ms']:.3f} ms of "
        f"device time in {rows16['profile_launches']} launches over "
        f"{res['profile_chunks']} profiled chunks")
    if tuple(img.shape) != (800, 800, 3) or not bool(
            torch.isfinite(img).all()):
        fail("the 800x800 render is not a finite 800x800x3 image")
    if g1 == 0 or res["g1_launches"] == 0 or res["e1_launches"] == 0:
        fail("G1 or E1 never launched during the render")
    if k1 != 0:
        fail(f"K1 launched {k1} times during the render")
    if "rows" not in seen:
        fail(f"no band-sample encode at chunk {RENDER_CHUNK} "
             f"({seen['calls']} recorded)")
    if not rows16["render_launches"]:
        fail("G1's 16-byte path never launched during the render")
    rows = seen["rows"]
    what = (f"render stream (chunk {RENDER_CHUNK}'s band-sample encode, "
            f"rows {list(rows.shape)})")
    log_runs(torch, rows, what)
    stream = check_gather(torch, gather, seen["table"], rows.reshape(-1),
                          what)
    saved = {"render_rows": rows.cpu(), "render_table": seen["table"].cpu()}
    if "table" not in baked:
        fail(f"no baked-SDF read at chunk {RENDER_CHUNK}")
    saved["bake_table"] = baked["table"].cpu()
    for part, name in (("probe", "visibility probe"),
                       ("alpha", "secondary alpha")):
        if not baked[part]:
            fail(f"no {name} read of the bake at chunk {RENDER_CHUNK}")
        idx = torch.cat(baked[part])
        rows16[f"bake_{part}"] = check_gather(
            torch, gather, baked["table"], idx,
            f"bake stream, {name} (chunk {RENDER_CHUNK}, "
            f"{len(baked[part])} gather(s))")
        saved[f"bake_{part}_rows"] = idx.cpu()
    if "bake" not in seen:
        fail(f"no bake encode of {BAKE_CHUNK} points")
    e1 = check_eval_encode(torch, *seen.pop("render"),
                           f"eval encode, render stream (chunk "
                           f"{RENDER_CHUNK}'s band samples)")
    e1["bake_stream"] = check_eval_encode(
        torch, *seen.pop("bake"), "eval encode, bake stream (one chunk)")
    e1["launches"] = res["e1_launches"]
    return g1, stream, saved, sphere, rows16, e1


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

    def recording_lookup(table, rows, *rest):
        vals = lookup(table, rows, *rest)
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


def flagship_phase(torch, scatter, gather, steps, host_streams):
    """The flagship's training at full width in its two windows (see the
    module docstring, phase 8), then validation of one view; the table
    gradient of stage-1 step 13009 against the plain scatter of every
    encode's recorded cotangent; K1 and G1 on that step's probe stream,
    which goes to ``host_streams["probe"]`` for phase 17a.  Returns K1's and
    G1's records of the probe stream, the profile and their launches in
    the phase."""
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

    def recording_lookup(tb, rows, *rest):
        vals = lookup(tb, rows, *rest)
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
    host_streams["probe"] = (stream["rows"], stream["vals"],
                             stream["table"].shape[0])
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
    modes' seconds per view and G1's launches per multi-emitter view,
    view 0's phys render and ground truth (phase 14d's LPIPS pair), its
    rays, depth and normals (phase 15b's shading points) and the GIFs'
    record (phase 15e)."""
    from rise_sdf_tpu_torch import measure

    torch.cuda.synchronize()
    gather.gather_rows.launches = 0
    scatter.scatter_add.launches = 0
    t0 = time.perf_counter()
    res = measure.test_protocol(system, state, views=views, log=log,
                                relights=TEST_LIGHTS)
    phase_s = time.perf_counter() - t0
    g1, k1 = gather.gather_rows.launches, scatter.scatter_add.launches
    gifs = check_test_gifs(os.path.join("exp", "test_protocol"),
                           int(state["step"]), views, "9")
    shutil.rmtree(os.path.join("exp", "test_protocol"), ignore_errors=True)
    multi, single = res["multi"], res["single"]
    check_protocol(res)
    per_view16 = multi["g1_16_launches"] / multi["views"]
    log(f"  phase {phase_s:.1f} s; G1 launches {g1} (multi-emitter: "
        f"{per_view16:g} per view on its 16-byte path, the baked-SDF "
        f"sample), K1 launches {k1}")
    return g1, {"multi_s_per_view": multi["s_per_view"],
                "single_s_per_view": single["s_per_view"],
                "multi_launches_per_view": multi["g1_launches"]
                / multi["views"],
                "multi_16_launches_per_view": per_view16}, \
        res["view0_pair"], res["view0_surface"], gifs


def check_protocol(res, lights=TEST_LIGHTS):
    """Print and check ``measure.test_protocol``'s result under the
    relight ``lights``: every metric
    finite, no ray dropped, G1 launching and K1 not in either mode, and
    the single-light view 0 within 1e-3 of the multi-emitter render in
    its metrics and 1e-4 in its images."""
    multi, single = res["multi"], res["single"]
    for name, run in (("multi-emitter", multi), ("single-light", single)):
        log(f"  {name}: {run['views']} views, {run['s_per_view']:.2f} "
            f"s/view ({run['render_s_per_view']:.2f} s/view rendering); "
            f"fractions {run['fractions']}; chunks rendered "
            f"{run['chunks']}; residual rays {run['residual_rays']}; G1 "
            f"launches {run['g1_launches']}, K1 launches "
            f"{run['k1_launches']}")
        log(f"    metrics {json.dumps(run['metrics'])}")
    log(f"  single-light view 0 vs multi-emitter view 0: max |difference| "
        f"{json.dumps(single['max_abs_diff'])}, share of pixels above 1e-4 "
        f"{json.dumps(single['share_above_1e-4'])}; metrics within "
        f"{single['max_metric_diff']:.2e}")
    want = {"psnr", "phys_psnr", "phys_ssim", "albedo_psnr", "albedo_ssim",
            "roughness_psnr", "normal_mae", "dropped_rays"} | {
        f"relight_{m}_{light}" for m in ("psnr", "ssim")
        for light in lights}
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


def _same_state(torch, src, dst, src_state, dst_state):
    """Names of the training-state tensors of ``dst`` that are not
    bit-equal to ``src``'s: params and persistent buffers, Adam's
    ``exp_avg``, ``exp_avg_sq`` and ``step`` for each, the groups' lr and
    weight decay, the schedule's ``last_epoch``, ``occs``, ``occ_binary``
    and ``step``."""
    bad = []
    dst_params = dst.model.state_dict(keep_vars=True)
    for name, p in src.model.state_dict(keep_vars=True).items():
        q = dst_params[name]
        if not torch.equal(p, q):
            bad.append(name)
        a, b = src.optimizer.state[p], dst.optimizer.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            if not torch.equal(a[k].cpu(), b[k].cpu()):
                bad.append(f"{k}:{name}")
    for ga, gb in zip(src.optimizer.param_groups, dst.optimizer.param_groups):
        if (ga["lr"], ga["weight_decay"]) != (gb["lr"], gb["weight_decay"]):
            bad.append(f"lr:{ga['name']}")
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
    e1 = e1_launches()
    times = {}
    t0 = time.perf_counter()
    mesh = system.export(final, times)
    export_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    g1_export, k1_export = (gather.gather_rows.launches,
                            scatter.scatter_add.launches)
    e1_export = e1_launches() - e1
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
        f"{peak / 2 ** 30:.2f} GiB; G1 launches {g1_export}, E1 launches "
        f"{e1_export}, K1 launches {k1_export}")
    if e1_export == 0 or k1_export != 0:
        fail(f"export launched E1 {e1_export}, K1 {k1_export} times")
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
           "dataset.n_images=1",
           "dataset.img_wh=[{},{}]".format(*SMALL_VIEW_WH),
           "--exp_dir", exp_dir]
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
            "e1_export": e1_export,
            "k1_per_step": k1_step, "g1_per_step": g1_step}


def second_card_phase(torch, scatter, gather):
    """K1 and G1 on ``cuda:1`` against their plain versions (K1 to the
    float64 reference's per-entry bound, G1 bit for bit)."""
    dev = torch.device("cuda", 1)
    gen = torch.Generator(device=dev).manual_seed(3)
    t = 2 ** 19
    idx = torch.randint(0, t, (8388608,), generator=gen, device=dev,
                        dtype=torch.int32)
    vals = torch.randn((idx.numel(), F), generator=gen, device=dev)
    got = scatter.scatter_add(idx, vals, t, 128)
    torch.cuda.synchronize(dev)
    check_scatter(torch, got, idx, vals, t, f"cuda:1, {idx.numel()} rows "
                  f"into {t} x {F}, P = 128")
    table = torch.randn((t, F), generator=gen, device=dev)
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize(dev)
    equal = torch.equal(got, gather.gather_rows_plain(table, idx))
    log(f"  cuda:1, G1 {idx.numel()} rows from {t} x {F}: bit-equal to "
        f"the plain gather {equal}")
    if not equal:
        fail("G1 on cuda:1 differs from its plain version")


def ddp_phase(torch, scatter, gather):
    """The flagship over data-parallel ranks (module docstring, phase
    11).  Returns K1's and G1's launches per rank in the window."""
    from rise_sdf_tpu_torch import datasets, measure, systems
    from rise_sdf_tpu_torch.presets import split_mixed_occ_train_full

    world, backend = measure.ddp_plan()
    steps = measure.DDP_STEPS
    out = os.path.join("exp", "chip_smoke_ddp")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    runs = [(world, backend, True)]
    if backend == "gloo":  # one card: NCCL at world size 1 as well
        runs.append((1, "nccl", False))
    reports = {}
    for n, be, validate in runs:
        t0 = time.perf_counter()
        ranks = measure.ddp_window(n, be, os.path.join(out, f"{be}{n}"),
                                   validate=validate)
        log(f"  {be}, world size {n} ({', '.join(r['device'] for r in ranks)}"
            f"): {time.perf_counter() - t0:.1f} s with the ranks' start")
        for r in ranks:
            k1s, g1s = zip(*r["launches_per_step"])
            log(f"    rank {r['rank']}: {r['rays_per_rank']} rays/step, "
                f"{r['steps']} steps in {r['fit_s']:.1f} s, "
                f"{r['steps_per_s']:.3f} steps/s after the first 4; "
                f"all-reduce {r['allreduce_ms']:.3f} ms for "
                f"{r['allreduce_mb']:.1f} MB per step (median of 10); peak "
                f"{r['peak_gib']:.2f} GiB; K1/G1 launches {r['k1_launches']}"
                f"/{r['g1_launches']} ({min(k1s)}-{max(k1s)} / "
                f"{min(g1s)}-{max(g1s)} per step); skipped {r['skipped']}; "
                f"params and grid equal across ranks {r['params_equal']}")
            gc = r["grad_check"]
            log(f"    rank {r['rank']}: step {measure.SPLIT_PROFILE_FROM} "
                f"table gradient vs the ranks' float64 mean: max relative "
                f"error {gc['max_rel_err']:.3e}, entries over the bound "
                f"(one ulp at two ranks) {gc['over_bound']} of "
                f"{gc['entries']} (max |mean| {gc['max_abs_mean']:.3e})")
            if "val" in r:
                log(f"    rank {r['rank']}: sharded validation view in "
                    f"{r['val_s']:.1f} s: {r['val']}; K1/G1 launches "
                    f"{r['val_launches']}")
            if len(r["losses"]) != steps or not np.all(np.isfinite(
                    r["losses"])) or r["skipped"]:
                fail(f"rank {r['rank']} of {be}{n}: losses {r['losses']}, "
                     f"skipped {r['skipped']}")
            if min(k1s) < 1 or min(g1s) < 1:
                fail(f"rank {r['rank']} of {be}{n}: a step without a K1 or "
                     f"G1 launch: {r['launches_per_step']}")
            if gc["over_bound"]:
                fail("the all-reduced table gradient is out of bound of "
                     "the ranks' float64 mean")
            if not r["params_equal"]:
                fail(f"the ranks' params differ after the {be}{n} window")
            if "val" in r and not (np.isfinite(r["val"]["psnr"])
                                   and np.isfinite(r["val"]["phys_psnr"])):
                fail(f"sharded validation {r['val']}")
        reports[f"{be}{n}"] = ranks

    # the one-process render of the state the ranks ended with
    ranks = reports[f"{backend}{world}"]
    cfg = split_mixed_occ_train_full()
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=os.path.join(out, "one"), device="cuda")
    state = system.load_checkpoint(ranks[0]["ckpt"])
    t0 = time.perf_counter()
    one = system.render_image(state, system.datamodule.val(), 0)
    one_s = time.perf_counter() - t0
    sharded = np.load(os.path.join(out, f"{backend}{world}",
                                   "val_view0.npz"))
    diffs = {k: float(np.abs(sharded[k] - one[k]).max()) for k in sorted(one)
             if k != "ray_included"}
    log(f"  one-process render of rank 0's checkpoint (step "
        f"{int(state['step'])}) in {one_s:.1f} s; sharded vs one-process, "
        f"max |difference|: {json.dumps(diffs)}; rays dropped "
        f"{int((~sharded['ray_included']).sum())} sharded, "
        f"{int((~one['ray_included']).sum())} one-process")
    worst = max(diffs[k] for k in ("comp_rgb_full", "comp_rgb_phys_full",
                                   "opacity", "depth"))
    if worst > 2e-3:
        fail(f"the sharded validation view is {worst:.3e} from the "
             "one-process render")
    del system, state
    shutil.rmtree(out, ignore_errors=True)
    if torch.cuda.device_count() >= 2:
        second_card_phase(torch, scatter, gather)
    return {"backend": backend, "world": world,
            "k1_per_rank": [r["k1_launches"] for r in ranks],
            "g1_per_rank": [r["g1_launches"] for r in ranks],
            "steps": steps,
            "allreduce_ms": [r["allreduce_ms"] for r in ranks],
            "steps_per_s": [r["steps_per_s"] for r in ranks]}


# phase 12: a scene from disk.  Cut from a TensoIR scene's 100 train and
# 200 test views and 5 relight environments from files to these views
# and the 2 analytic environments; 16 steps per training window
SCENE_SIZE, SCENE_TRAIN_VIEWS, SCENE_STEPS = 800, 4, 16
SCENE_LIGHTS = ("warm", "bright")
# PNGs in one TensoIR scene: 100 train + 200 test views, a test view
# also with rgba_{light}.png for 5 lights
TENSOIR_PNGS = 100 + 200 * (1 + 5)


def write_png_filters(path, img):
    """uint8 [H, W, C] as an 8-bit PNG (C = 3: RGB, 4: RGBA) whose rows
    cycle through the five filters (None, Sub, Up, Average, Paeth)."""
    import struct
    import zlib

    h, w, c = img.shape
    x = img.astype(np.int16)
    left, up, corner = (np.zeros_like(x) for _ in range(3))
    left[:, 1:], up[1:], corner[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb = np.abs(up - corner), np.abs(left - corner)
    pc = np.abs(left + up - 2 * corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, corner))
    kind = np.arange(h) % 5
    pred = np.choose(kind[:, None, None], [np.zeros_like(x), left, up,
                                           (left + up) >> 1, paeth])
    rows = np.concatenate([kind[:, None].astype(np.uint8),
                           ((x - pred) & 0xFF).astype(np.uint8).reshape(
                               h, w * c)], 1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def _rle_plane(plane):
    """One component plane of a scanline in Radiance's new run-length
    code: runs of 4 or more equal bytes as (128 + n, byte), the rest as
    literal spans (n, n bytes) of at most 128."""
    out, lit = bytearray(), bytearray()

    def flush():
        for k in range(0, len(lit), 128):
            out.append(len(lit[k:k + 128]))
            out.extend(lit[k:k + 128])
        lit.clear()

    starts = np.concatenate([[0], np.flatnonzero(np.diff(plane)) + 1])
    for start, n in zip(starts, np.diff(np.append(starts, len(plane)))):
        if n >= 4:
            flush()
            while n > 0:
                out.extend((128 + min(n, 127), int(plane[start])))
                n -= min(n, 127)
        else:
            lit.extend(plane[start:start + n].tobytes())
    flush()
    return bytes(out)


def write_hdr_rle(path, rgb):
    """float32 [H, W, 3] as a Radiance RGBE file with new-style
    run-length scanlines, each texel's mantissas truncated as Radiance's
    ``float2rgbe`` does.  RGBE holds no negative radiance: the caller
    clips at 0."""
    h, w, _ = rgb.shape
    top = rgb.max(-1).astype(np.float64)
    frac, exp = np.frexp(top)
    zero = top < 1e-32
    scale = np.where(zero, 0.0, frac * 256.0 / np.where(zero, 1.0, top))
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.minimum(rgb * scale[..., None], 255).astype(np.uint8)
    rgbe[..., 3] = np.where(zero, 0, exp + 128)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            f.write(bytes((2, 2, w >> 8, w & 0xFF)))
            for p in range(4):
                f.write(_rle_plane(rgbe[y, :, p]))


# how long phases 12 and 13 wait at most for their scene's writer
WRITER_TIMEOUT_S = 600


def _timed(fn, *args):
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def start_writers():
    """Phases 12a and 13a's scenes (numpy renders and PNG encodes, about
    75 s on the host), written by two spawned worker processes while the
    card runs the phases before them.  Returns the scene's and the
    capture's directories (the capture under ``png/``) and the two
    pending results, each ``(what was written, seconds)``.  The workers
    are stopped and the directories removed at exit."""
    import multiprocessing

    roots = tuple(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
                  for name in ("scene", "capture"))
    for root in roots:
        atexit.register(shutil.rmtree, root, True)
    os.makedirs(os.path.join(roots[1], "png"))
    pool = multiprocessing.get_context("spawn").Pool(2)
    # at exit (last registered, first run): stop, then wait for, both
    atexit.register(pool.join)
    atexit.register(pool.terminate)
    jobs = (pool.apply_async(_timed, (write_scene, roots[0], SCENE_SIZE,
                                      SCENE_TRAIN_VIEWS)),
            pool.apply_async(_timed, (write_capture,
                                      os.path.join(roots[1], "png"),
                                      CAPTURE_W, CAPTURE_H, CAPTURE_VIEWS)))
    pool.close()
    return roots, jobs


def write_scene(root, size, n_train):
    """The concave scene rendered by ``render_image_concave`` at
    ``size``^2 under the ``bright`` environment, written in the TensoIR
    layout under ``root/tensoir`` (``n_train`` train views and one test
    view, each with ``rgba_warm.png`` and ``rgba_bright.png``), the
    environments as ``root/envs/{warm,bright}.hdr``, and the images in
    the Blender layout under ``root/blender``
    (``transforms_{train,test}.json``, ``{train,test}/r_N.png``).
    Returns what was written: per view its pose, uint8 RGBA, albedo,
    roughness, normal and rays, and the environments' lat-long images
    (clipped at 0)."""
    import math

    from rise_sdf_tpu_torch.datasets import synthetic as syn
    from rise_sdf_tpu_torch.utils.exr import write_exr
    from rise_sdf_tpu_torch.utils.rays import get_ray_directions

    fov = 0.42  # the concave scene's default
    focal = 0.5 * size / math.tan(0.5 * fov)
    dirs = get_ray_directions(size, size, focal, focal, size // 2, size // 2)
    written = {"views": {}, "envs": {}}
    os.makedirs(os.path.join(root, "envs"))
    for light in SCENE_LIGHTS:
        # the warm sky goes below 0 under the horizon
        img = np.maximum(syn.env_latlong(syn._ENVS[light]), 0)
        write_hdr_rle(os.path.join(root, "envs", f"{light}.hdr"), img)
        written["envs"][light] = img

    def rgba(rgb, mask):
        return np.round(np.clip(np.concatenate(
            [rgb, mask[..., None]], -1), 0, 1) * 255).astype(np.uint8)

    for split, n, seed in (("train", n_train, 0), ("test", 1, 2)):
        os.makedirs(os.path.join(root, "blender", split))
        frames = []
        for i, c2w in enumerate(syn.camera_poses(n, seed=seed)):
            view = os.path.join(root, "tensoir", f"{split}_{i:03d}")
            os.makedirs(view)
            mat = np.concatenate([c2w, [[0, 0, 0, 1]]])
            with open(os.path.join(view, "metadata.json"), "w") as f:
                json.dump({"cam_transform_mat": ",".join(
                    repr(float(v)) for v in mat.reshape(-1)),
                    "cam_angle_x": fov}, f)
            rgb, mask, alb, rough, nrm = syn.render_image_concave(
                c2w, dirs, env_fn=syn.env_radiance_bright)
            png = rgba(rgb, mask)
            write_png_filters(os.path.join(view, "rgba.png"), png)
            write_png_filters(os.path.join(root, "blender", split,
                                           f"r_{i}.png"), png)
            write_exr(os.path.join(view, "albedo.exr"), alb)
            write_exr(os.path.join(view, "roughness.exr"), rough)
            write_exr(os.path.join(view, "normal.exr"),
                      np.concatenate([nrm, mask[..., None]], -1))
            rec = {"c2w": c2w, "rgba": png, "albedo": alb, "roughness": rough,
                   "normal": nrm, "rays": dirs @ c2w[:3, :3].T}
            # the loaders read the relight images of every split
            for light in SCENE_LIGHTS:
                rel = rgb if light == "bright" else syn.render_image_concave(
                    c2w, dirs, env_fn=syn._ENVS[light])[0]
                rec[light] = rgba(rel, mask)
                write_png_filters(os.path.join(view, f"rgba_{light}.png"),
                                  rec[light])
            written["views"][(split, i)] = rec
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": mat.tolist()})
        with open(os.path.join(root, "blender", f"transforms_{split}.json"),
                  "w") as f:
            json.dump({"camera_angle_x": fov, "frames": frames}, f)
    return written


def check_scene(root, written, relights):
    """Load the scene through ``datasets.make`` in both layouts and hold
    it to what was written (module docstring, phase 12b).  Returns the
    seconds per PNG decode."""
    from rise_sdf_tpu_torch import datasets
    from rise_sdf_tpu_torch.utils.hdr import read_hdr
    from rise_sdf_tpu_torch.utils.png import read_png

    pngs, decode_s = 0, 0.0
    for (split, i), rec in written["views"].items():
        view = os.path.join(root, "tensoir", f"{split}_{i:03d}")
        paths = [(os.path.join(view, "rgba.png"), rec["rgba"]),
                 (os.path.join(root, "blender", split, f"r_{i}.png"),
                  rec["rgba"])]
        paths += [(os.path.join(view, f"rgba_{light}.png"), rec[light])
                  for light in relights]
        for path, want in paths:
            t0 = time.perf_counter()
            got = read_png(path)
            decode_s += time.perf_counter() - t0
            pngs += 1
            if not np.array_equal(got, want):
                fail(f"{path} does not decode to the bytes written")
    ms = decode_s / pngs * 1e3
    size = written["views"][("train", 0)]["rgba"].shape[0]
    log(f"  b. {pngs} PNGs of {size}x{size} RGBA (rows cycling the five "
        f"filters) decode to the bytes written: {ms:.1f} ms per image; a "
        f"TensoIR scene's {TENSOIR_PNGS} PNGs would take "
        f"{ms * TENSOIR_PNGS / 1e3:.0f} s")
    for light, img in written["envs"].items():
        got = read_hdr(os.path.join(root, "envs", f"{light}.hdr"))
        bound = img.max(-1, keepdims=True) * 2.0 ** -7
        over = int((np.abs(got - img) > bound).sum())
        log(f"  {light}.hdr {got.shape[1]}x{got.shape[0]}: max |read - "
            f"analytic| {float(np.abs(got - img).max()):.3e}, texels over "
            f"2^-7 of their largest channel: {over}")
        if got.shape != img.shape or over:
            fail(f"{light}.hdr is not the environment within RGBE's "
                 "quantization")
    base = {"img_wh": [size, size], "near_plane": 2.0, "far_plane": 6.0,
            "openGL_camera": True}
    t0 = time.perf_counter()
    tensoir = datasets.make("tensoir", dict(
        base, root_dir=os.path.join(root, "tensoir"),
        relight_list=list(relights), has_albedo=True, albedo_format="exr",
        has_roughness=True, roughness_format="exr"))
    blender = datasets.make("blender", dict(
        base, root_dir=os.path.join(root, "blender")))
    splits = {(layout, name): getattr(dm, name)()
              for layout, dm in (("tensoir", tensoir), ("blender", blender))
              for name in ("train", "test")}
    load_s = time.perf_counter() - t0
    worst = {"normal": 0.0, "rays": 0.0}
    for (layout, name), split in splits.items():
        for i in range(len(split)):
            rec = written["views"][(name, i)]
            want = rec["rgba"].astype(np.float32) / 255.0
            c2w = split.all_c2w[i]
            ray_err = float(np.abs(split.directions @ c2w[:3, :3].T
                                   - rec["rays"]).max())
            worst["rays"] = max(worst["rays"], ray_err)
            same = (np.array_equal(split.all_images[i], want[..., :3])
                    and np.array_equal(split.all_fg_masks[i], want[..., 3])
                    and np.array_equal(c2w[:, 3], rec["c2w"][:, 3]))
            if layout == "tensoir":
                same = same and all(
                    np.array_equal(split.relight_images[light][i],
                                   rec[light][..., :3].astype(np.float32)
                                   / 255.0)
                    for light in relights) \
                    and np.array_equal(split.all_albedo[i], rec["albedo"]) \
                    and np.array_equal(split.all_roughness[i],
                                       rec["roughness"])
                worst["normal"] = max(worst["normal"], float(np.abs(
                    split.all_normals[i] - rec["normal"]).max()))
            if not same or ray_err > 1e-6:
                fail(f"{layout} {name} view {i} differs from what was "
                     f"written (rays {ray_err:.2e})")
    counts = ", ".join(f"{layout} {name} {len(split)}"
                       for (layout, name), split in splits.items())
    log(f"  loaded both layouts ({counts} views) in "
        f"{load_s:.1f} s: images, masks, albedo and roughness EXRs and "
        f"relight images equal to what was written; max |normal - "
        f"renderer's| {worst['normal']:.2e}, max |directions @ c2w - the "
        f"rendered rays| {worst['rays']:.2e}")
    if worst["normal"] > 1e-6:
        fail("the loaded normals are not the renderer's")


def _train_window(torch, scatter, gather, system, state, steps, seed,
                  each_step=None):
    """``steps`` steps of ``fit`` from ``state`` with K1's and G1's counts
    zeroed just before and read per step (``each_step(step, metrics)``
    after each, if given).  Returns the state, steps/s over all but the
    first step, the peak memory in GiB, the launches per step and the
    losses."""
    from rise_sdf_tpu_torch import measure

    per_step, losses = [], []

    def on_log(step, m):
        per_step.append((scatter.scatter_add.launches,
                         gather.gather_rows.launches))
        losses.append(m["loss"])
        if each_step is not None:
            each_step(step, m)

    start = int(state["step"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scatter.scatter_add.launches = 0
    gather.gather_rows.launches = 0
    state, _, rate, _ = measure.train(system, steps, seed, state, on_log,
                                      profile_from=start + steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    deltas = [(k - k0, g - g0) for (k, g), (k0, g0)
              in zip(per_step, [(0, 0)] + per_step[:-1])]
    return state, rate, peak, deltas, losses


def scene_phase(torch, scatter, gather, root, job):
    """A scene from disk (module docstring, phase 12), written under
    ``root`` by ``job`` (``start_writers``; phase 17c reads it again).
    Returns K1's and G1's launches in its three parts."""
    from rise_sdf_tpu_torch import datasets, launch, measure, presets, \
        systems

    out = os.path.join("exp", "chip_smoke_scene")
    shutil.rmtree(out, ignore_errors=True)
    launches = {}
    t0 = time.perf_counter()
    written, took = job.get(WRITER_TIMEOUT_S)
    log(f"  a. wrote the concave scene at {SCENE_SIZE}x{SCENE_SIZE} "
        f"({SCENE_TRAIN_VIEWS} "
        f"train views, 1 test view, {', '.join(SCENE_LIGHTS)}) in the "
        f"TensoIR and Blender layouts in {took:.1f} s on a worker "
        f"process (waited {time.perf_counter() - t0:.1f} s)")
    check_scene(root, written, SCENE_LIGHTS)

    cfg = launch.resolve(launch.apply_overrides(
        presets.split_mixed_occ_tensoir(),
        ["dataset.scene=concave",
         f"dataset.root_dir={os.path.join(root, 'tensoir')}",
         f"dataset.hdr_filepath={os.path.join(root, 'envs')}",
         f"dataset.relight_list=[{','.join(SCENE_LIGHTS)}]"]))
    seed = int(cfg["seed"])
    t0 = time.perf_counter()
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=os.path.join(out, "split", "save"),
                          ckpt_dir=os.path.join(out, "split", "ckpt"),
                          device="cuda")
    state = system.init_state(seed)
    state["step"] = measure.SPLIT_STAGE1_STEP
    log(f"  c. {cfg['name']}: system built in "
        f"{time.perf_counter() - t0:.1f} s")
    state, rate, peak, deltas, losses = _train_window(
        torch, scatter, gather, system, state, SCENE_STEPS, seed)
    k1, g1 = (sum(d) for d in zip(*deltas))
    launches["train_tensoir"] = (k1, g1)
    log(f"    fit {measure.SPLIT_STAGE1_STEP} -> {int(state['step'])}: "
        f"{rate:.3f} steps/s over the last {SCENE_STEPS - 1} steps; "
        f"peak {peak:.2f} GiB; K1/G1 launches {k1}/{g1} (per step "
        f"{min(d[0] for d in deltas)}-{max(d[0] for d in deltas)} / "
        f"{min(d[1] for d in deltas)}-{max(d[1] for d in deltas)}); "
        f"skipped updates {system.skipped_updates}; last loss "
        f"{losses[-1]:.5f}")
    if len(losses) != SCENE_STEPS or not np.all(np.isfinite(losses)) \
            or system.skipped_updates:
        fail(f"flagship on the loaded scene: losses {losses}, skipped "
             f"{system.skipped_updates}")
    if min(min(d) for d in deltas) < 1:
        fail(f"a flagship step on the loaded scene without a K1 or G1 "
             f"launch: {deltas}")
    torch.cuda.synchronize()
    scatter.scatter_add.launches = 0
    gather.gather_rows.launches = 0
    t0 = time.perf_counter()
    res = system.test(state, export=False)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    k1, g1 = scatter.scatter_add.launches, gather.gather_rows.launches
    launches["test_tensoir"] = (k1, g1)
    hdrs = ", ".join(f"{light}.hdr" for light in SCENE_LIGHTS)
    log(f"    test on 1 view relit by {hdrs} in "
        f"{test_s:.1f} s: {json.dumps(res)}; K1/G1 launches {k1}/{g1}; "
        f"dropped rays {res['dropped_rays']} (a fresh init at stage 1)")
    want = {f"relight_{m}_{light}" for m in ("psnr", "ssim")
            for light in SCENE_LIGHTS}
    if not want <= set(res) or not all(np.isfinite(v)
                                       for v in res.values()):
        fail(f"test on the loaded scene: {res}")
    if g1 == 0 or k1 != 0:
        fail(f"test on the loaded scene launched K1 {k1}, G1 {g1} times")
    del system, state
    torch.cuda.empty_cache()

    cfg = launch.resolve(launch.apply_overrides(
        presets.neus_blender(),
        ["dataset.scene=concave",
         f"dataset.root_dir={os.path.join(root, 'blender')}"]))
    t0 = time.perf_counter()
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=os.path.join(out, "neus", "save"),
                          ckpt_dir=os.path.join(out, "neus", "ckpt"),
                          device="cuda")
    state = system.init_state(seed)
    log(f"  d. {cfg['name']}: system built in "
        f"{time.perf_counter() - t0:.1f} s")
    state, rate, peak, deltas, losses = _train_window(
        torch, scatter, gather, system, state, SCENE_STEPS, seed)
    k1, g1 = (sum(d) for d in zip(*deltas))
    launches["train_blender"] = (k1, g1)
    log(f"    fit 0 -> {int(state['step'])}: {rate:.3f} steps/s over "
        f"the last {SCENE_STEPS - 1} steps; peak {peak:.2f} GiB; K1/G1 "
        f"launches {k1}/{g1}; skipped updates {system.skipped_updates}; "
        f"last loss {losses[-1]:.5f}")
    if len(losses) != SCENE_STEPS or not np.all(np.isfinite(losses)) \
            or system.skipped_updates:
        fail(f"NeuS on the loaded scene: losses {losses}, skipped "
             f"{system.skipped_updates}")
    if min(min(d) for d in deltas) < 1:
        fail(f"a NeuS step on the loaded scene without a K1 or G1 "
             f"launch: {deltas}")
    del system, state
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    return launches


# phase 13: a real capture.  Written at 1600x1064 and loaded at
# img_downscale 2 (800x532), where a capture has 100-300 views of ~5000
# pixels loaded at 4; 9 views on a ring; 32 of 20,000 steps
CAPTURE_W, CAPTURE_H, CAPTURE_DOWNSCALE = 1600, 1064, 2
CAPTURE_VIEWS, CAPTURE_STEPS, CAPTURE_FOCAL = 9, 32, 1200.0
# the cameras' ring (radius, height): 2.5x the object's extent of 0.8
CAPTURE_RING = (2.0, 1.33)
# the floor disk under the object (radius 3x its extent)
FLOOR_Z, FLOOR_R = -0.5, 2.4
# COLMAP's world frame: scale, rotation (qvec) and offset of the scene's
COLMAP_SCALE, COLMAP_QVEC, COLMAP_T = 1.7, (0.9, 0.3, -0.2, 0.25), \
    (0.4, -1.1, 2.0)
CAPTURE_DISTORTION = 0.01  # lambda_distortion of the one step of 13d


def _rotmat2qvec(r):
    """Unit (w, x, y, z), w >= 0, of a rotation (COLMAP's
    ``rotmat2qvec``)."""
    r = np.asarray(r, np.float64).T
    k = np.array([
        [r[0, 0] - r[1, 1] - r[2, 2], 0, 0, 0],
        [r[1, 0] + r[0, 1], r[1, 1] - r[0, 0] - r[2, 2], 0, 0],
        [r[2, 0] + r[0, 2], r[2, 1] + r[1, 2], r[2, 2] - r[0, 0] - r[1, 1],
         0],
        [r[1, 2] - r[2, 1], r[2, 0] - r[0, 2], r[0, 1] - r[1, 0],
         r[0, 0] + r[1, 1] + r[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q if q[0] >= 0 else -q


def write_colmap_sparse(sparse, w, h, focal, w2c, names, points):
    """COLMAP's binary model: one PINHOLE camera, an image per
    world-to-camera (qvec, tvec) of ``w2c`` with no 2-D points, and the
    [P, 3] ``points`` with empty tracks."""
    import struct

    os.makedirs(sparse)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<QiiQQ", 1, 1, 1, w, h))
        f.write(struct.pack("<4d", focal, focal, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, ((q, t), name) in enumerate(zip(w2c, names)):
            f.write(struct.pack("<idddddddi", i + 1, *q, *t, 1))
            f.write(name.encode() + b"\x00" + struct.pack("<Q", 0))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for i, p in enumerate(points):
            f.write(struct.pack("<QdddBBBdQ", i + 1, *p, 128, 128, 128, 0.5,
                                0))


def write_capture(root, w, h, n_views):
    """The concave scene (``render_image_concave`` under ``env_radiance``)
    on a checkered floor disk at ``FLOOR_Z``, with the environment seen at
    infinity around both, photographed by ``n_views`` cameras on a ring
    and written in COLMAP's layout: ``images/NNN.png`` (RGB) and
    ``sparse/0`` with a PINHOLE camera, each view's world-to-camera pose
    in COLMAP's convention and world frame (a similarity of the scene's),
    and points3D: object and floor hit points of every 16th pixel row and
    column.  Returns the views' scene-frame OpenGL poses and uint8
    images, the points (scene frame) and which of them lie on the floor,
    and the sparse model's poses and points (COLMAP's frame)."""
    from rise_sdf_tpu_torch.datasets import synthetic as syn
    from rise_sdf_tpu_torch.datasets.colmap_utils import qvec2rotmat
    from rise_sdf_tpu_torch.utils.rays import get_ray_directions

    dirs = get_ray_directions(w, h, CAPTURE_FOCAL, CAPTURE_FOCAL, w / 2,
                              h / 2)
    rot = qvec2rotmat(np.asarray(COLMAP_QVEC) / np.linalg.norm(COLMAP_QVEC))
    flip = np.diag([1.0, -1.0, -1.0])  # OpenGL camera axes <-> COLMAP's
    os.makedirs(os.path.join(root, "images"))
    views, w2c, names, pts, floor = [], [], [], [], []
    extent = syn.CONCAVE_TORUS_R + syn.CONCAVE_TORUS_r
    for i in range(n_views):
        a = 2 * np.pi * (i + 0.25) / n_views
        eye = np.array([CAPTURE_RING[0] * np.cos(a),
                        CAPTURE_RING[0] * np.sin(a), CAPTURE_RING[1]])
        c2w = syn.look_at(eye).astype(np.float64)
        rgb, mask = syn.render_image_concave(c2w, dirs,
                                             env_fn=syn.env_radiance)[:2]
        d = dirs.astype(np.float64) @ c2w[:3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = (FLOOR_Z - eye[2]) / np.minimum(d[..., 2], -1e-9)
        p = eye + t[..., None] * d
        on_floor = (d[..., 2] < 0) & (np.hypot(p[..., 0], p[..., 1])
                                      < FLOOR_R) & (mask == 0)
        check = (np.floor(2 * p[..., 0]) + np.floor(2 * p[..., 1])) % 2
        floor_rgb = np.where(check[..., None] > 0, [0.62, 0.52, 0.38],
                             [0.30, 0.26, 0.22])
        env = np.clip(syn.env_radiance(d.astype(np.float32)), 0, None)
        env_srgb = np.where(env <= 0.0031308, env * 12.92,
                            1.055 * np.maximum(env, 0.0031308) ** (1 / 2.4)
                            - 0.055)
        img = np.where(mask[..., None] > 0, rgb,
                       np.where(on_floor[..., None], floor_rgb, env_srgb))
        png = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
        name = f"{i:03d}.png"
        write_png_filters(os.path.join(root, "images", name), png)
        views.append({"c2w": c2w.astype(np.float32), "png": png})
        # points3D from every 16th pixel
        sub = (slice(None, None, 16), slice(None, None, 16))
        obj = mask[sub] > 0
        ds = d[sub][obj]
        hit, th = syn.sphere_trace_np(np.broadcast_to(eye, ds.shape).copy(),
                                      ds, np.linalg.norm(eye) - extent - 0.2,
                                      np.linalg.norm(eye) + extent + 0.2)
        pts += [eye + th[hit, None] * ds[hit], p[sub][on_floor[sub]]]
        floor += [np.zeros(int(hit.sum()), bool),
                  np.ones(int(on_floor[sub].sum()), bool)]
        # COLMAP: camera-to-world in its world frame and camera axes
        r_c2w = rot @ c2w[:3, :3] @ flip
        center = COLMAP_SCALE * rot @ eye + np.asarray(COLMAP_T)
        w2c.append((_rotmat2qvec(r_c2w.T), -r_c2w.T @ center))
        names.append(name)
    pts, floor = np.concatenate(pts), np.concatenate(floor)
    colmap_pts = COLMAP_SCALE * pts @ rot.T + np.asarray(COLMAP_T)
    write_colmap_sparse(os.path.join(root, "sparse", "0"), w, h,
                        CAPTURE_FOCAL, w2c, names, colmap_pts)
    return {"views": views, "points": pts, "floor": floor, "w2c": w2c,
            "colmap_points": colmap_pts}


def check_capture(dm, written):
    """Hold the loaded splits to what was written (module docstring,
    phase 13a).  Returns the splits."""
    from rise_sdf_tpu_torch.utils.image import resize_like_pil

    splits = {name: getattr(dm, name)() for name in ("train", "test",
                                                     "predict")}
    hold = int(dm.config.get("hold_every", 8))
    ids = {"train": [i for i in range(CAPTURE_VIEWS) if i % hold],
           "test": [i for i in range(CAPTURE_VIEWS) if i % hold == 0]}
    wh = (CAPTURE_W // CAPTURE_DOWNSCALE, CAPTURE_H // CAPTURE_DOWNSCALE)
    worst = {"up": 0.0, "dist": 0.0, "height": 0.0}
    ratio = CAPTURE_RING[1] / float(np.hypot(*CAPTURE_RING))
    for name, idx in ids.items():
        split = splits[name]
        if (split.w, split.h) != wh or len(split) != len(idx):
            fail(f"capture {name}: {len(split)} views of {split.w}x"
                 f"{split.h}, expected {len(idx)} of {wh}")
        for k, i in enumerate(idx):
            want = resize_like_pil(written["views"][i]["png"], wh).astype(
                np.float32) / 255.0
            if not (np.array_equal(split.all_images[k], want)
                    and np.all(split.all_fg_masks[k] == 1.0)):
                fail(f"capture {name} view {i} is not resize_like_pil of "
                     "what was written")
            c2w, ref = split.all_c2w[k], written["views"][i]["c2w"]
            # the floor's normal is +z: a rotation about z and a scale
            # away from the scene's frame, which has z up
            worst["up"] = max(worst["up"], float(np.abs(
                c2w[2, :3] - ref[2, :3]).max()))
            worst["dist"] = max(worst["dist"], abs(float(
                np.linalg.norm(c2w[:, 3])) - 1.0))
            worst["height"] = max(worst["height"],
                                  abs(float(c2w[2, 3]) - ratio))
    pts = splits["train"].pts3d
    floor_z = pts[written["floor"], 2]
    want_z = FLOOR_Z / float(np.hypot(*CAPTURE_RING))
    spread = float(np.abs(floor_z - want_z).max())
    above = bool((pts[~written["floor"], 2] > floor_z.max()).all())
    pred = splits["predict"].all_c2w
    log(f"  a. loaded {len(splits['train'])} train, {len(splits['test'])} "
        f"test views ({wh[0]}x{wh[1]}, bit-equal to resize_like_pil of what "
        f"was written) and {len(pred)} predict poses; max |up row - the "
        f"scene's| {worst['up']:.2e}, |camera distance - 1| "
        f"{worst['dist']:.2e}, |height - {ratio:.4f}| "
        f"{worst['height']:.2e}; {int(written['floor'].sum())} floor points "
        f"at z {want_z:.4f} within {spread:.2e}, the "
        f"{int((~written['floor']).sum())} object points above: {above}")
    if max(worst.values()) > 1e-4 or spread > 1e-4 or not above:
        fail("the capture's poses are not normalised with the floor's "
             "normal as +z")
    if pred.shape != (120, 3, 4) or not np.isfinite(pred).all() or \
            np.abs(pred[:, 2, 3] - pred[0, 2, 3]).max() > 1e-5:
        fail(f"the predict trajectory: {pred.shape}")
    return splits


def _distortion_f64(out, n_rays):
    """The distortion term as a float64 per-ray double sum over the
    buffer's valid samples, divided by the included rays (the system's
    normalisation)."""
    valid = out["samples_valid"].cpu().numpy()
    w, m, d = (out[k].double().cpu().numpy()[valid]
               for k in ("weights", "points", "intervals"))
    ray = out["ray_indices"].cpu().numpy()[valid]
    bounds = np.searchsorted(ray, np.arange(n_rays + 1))
    total = 0.0
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b > a:
            ww, mm = w[a:b], m[a:b]
            total += ww @ np.abs(mm[:, None] - mm[None, :]) @ ww \
                + (ww * ww * d[a:b]).sum() / 3.0
    return total / max(int(out["ray_included"].sum()), 1)


def capture_phase(torch, scatter, gather, root, host_streams, job):
    """A real capture (module docstring, phase 13), written under
    ``root`` by ``job`` (``start_writers``); the background stream goes
    to ``host_streams["background"]`` for phase 17a.  Returns K1's and G1's
    records (launches per part and the background stream's checks and
    times) and what was written (``write_capture``)."""
    from rise_sdf_tpu_torch import datasets, launch, measure, presets, \
        systems
    from rise_sdf_tpu_torch.ops import hashgrid

    out_dir = os.path.join("exp", "chip_smoke_capture")
    shutil.rmtree(out_dir, ignore_errors=True)
    k1, g1 = {}, {}
    t0 = time.perf_counter()
    written, took = job.get(WRITER_TIMEOUT_S)
    log(f"  a. wrote the concave scene on its floor at {CAPTURE_W}x"
        f"{CAPTURE_H}, {CAPTURE_VIEWS} views on a ring, "
        f"{len(written['points'])} points, in COLMAP's layout in "
        f"{took:.1f} s on a worker process (waited "
        f"{time.perf_counter() - t0:.1f} s)")
    cfg = launch.resolve(launch.apply_overrides(
        presets.neus_colmap(),
        [f"dataset.root_dir={root}",
         f"dataset.img_downscale={CAPTURE_DOWNSCALE}"]))
    t0 = time.perf_counter()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    splits = check_capture(dm, written)
    log(f"     loading and checking took {time.perf_counter() - t0:.1f}"
        f" s")

    seed = int(cfg["seed"])
    t0 = time.perf_counter()
    system = systems.make(cfg["system"]["name"], cfg, dm,
                          save_dir=os.path.join(out_dir, "save"),
                          ckpt_dir=os.path.join(out_dir, "ckpt"),
                          device="cuda")
    state = system.init_state(seed)
    log(f"  b. {cfg['name']}: system built in "
        f"{time.perf_counter() - t0:.1f} s")
    bg_table = system.model.geometry_bg.encoding.encoding.table
    lookup = hashgrid.table_grad_lookup
    seen, stream = {}, {}

    def recording_lookup(table, rows, *rest):
        vals = lookup(table, rows, *rest)
        if vals.requires_grad and table.data_ptr() == \
                bg_table.data_ptr():
            vals.retain_grad()
            seen.update(rows=rows, vals=vals)
        return vals

    per_step, losses = [], []

    def on_log(step, m):
        per_step.append((scatter.scatter_add.launches,
                         gather.gather_rows.launches))
        losses.append(m["loss"])
        if step == 1:  # the background stream (step 0's is the same)
            hashgrid.table_grad_lookup = lookup
            rows, cot = seen.pop("rows"), seen.pop("vals").grad
            idx = rows.reshape(-1)
            vals = cot.reshape(-1, F).contiguous()
            grad = bg_table.grad.reshape(-1, F)
            stream["step_err"] = check_scatter(
                torch, grad, idx, vals, grad.shape[0],
                "step 1: the background table's gradient (K1) vs "
                "float64")
            stream.update(rows=rows.cpu(), vals=vals.cpu(),
                          table=bg_table.detach().reshape(-1, F).cpu())

    hashgrid.table_grad_lookup = recording_lookup
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        scatter.scatter_add.launches = 0
        gather.gather_rows.launches = 0
        state, _, rate, _ = measure.train(
            system, CAPTURE_STEPS, seed, state, on_log,
            profile_from=CAPTURE_STEPS, window=15)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        hashgrid.table_grad_lookup = lookup
    deltas = [(a - a0, b - b0) for (a, b), (a0, b0)
              in zip(per_step, [(0, 0)] + per_step[:-1])]
    k1["train_launches"], g1["train_launches"] = (
        sum(d) for d in zip(*deltas))
    k1["train_launches_per_step"] = sorted({d[0] for d in deltas})
    g1["train_launches_per_step"] = sorted({d[1] for d in deltas})
    log(f"    fit 0 -> {int(state['step'])}: {rate:.3f} steps/s over "
        f"the last 15 steps; peak {peak:.2f} GiB; K1/G1 launches "
        f"{k1['train_launches']}/{g1['train_launches']} (per step "
        f"{k1['train_launches_per_step']} / "
        f"{g1['train_launches_per_step']}); skipped updates "
        f"{system.skipped_updates}; losses {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}")
    if len(losses) != CAPTURE_STEPS or not np.all(np.isfinite(losses)) \
            or system.skipped_updates:
        fail(f"neus_colmap on the capture: losses {losses}, skipped "
             f"{system.skipped_updates}")
    if min(d[0] for d in deltas) < 2 or min(d[1] for d in deltas) < 2:
        fail(f"a neus_colmap step without two K1 and two G1 launches "
             f"(the foreground's and the background's tables): "
             f"{deltas}")
    if "rows" not in stream:
        fail("no background encode was recorded")

    # c. K1 and G1 on the background's encode stream
    host_streams["background"] = (stream["rows"], stream["vals"],
                                  stream["table"].shape[0])
    rows, vals, table = (stream.pop(k).cuda()
                         for k in ("rows", "vals", "table"))
    what = f"background stream (step 1, rows {list(rows.shape)})"
    log_runs(torch, rows, what)
    k1["bg_stream"] = check_time_scatter(
        torch, scatter, rows.reshape(-1), vals, table.shape[0], what,
        rows.shape[-2] * rows.shape[-1])
    k1["bg_stream"]["step_max_abs_err"] = stream.pop("step_err")
    g1["bg_stream"] = check_gather(torch, gather, table,
                                   rows.reshape(-1), what)
    del rows, vals, table
    torch.cuda.empty_cache()

    # d. one step with the distortion loss
    system.config["system"]["loss"]["lambda_distortion"] = \
        CAPTURE_DISTORTION
    compute_losses, kept = system.compute_losses, {}

    def spy(out, batch, step):
        loss, terms = compute_losses(out, batch, step)
        kept.update(out={k: out[k].detach() for k in (
            "weights", "points", "intervals", "ray_indices",
            "samples_valid", "ray_included")},
            distortion=float(terms["distortion"].detach()),
            n_rays=batch["rgb"].shape[0])
        return loss, terms

    system.compute_losses = spy
    metrics = []
    try:
        state = system.fit(max_steps=CAPTURE_STEPS + 1, seed=seed,
                           state=state, log_every=1,
                           on_log=lambda step, m: metrics.append(m))
    finally:
        del system.compute_losses
    ref = _distortion_f64(kept["out"], kept["n_rays"])
    rel = abs(kept["distortion"] - ref) / max(abs(ref), 1e-30)
    k1["distortion_rel_err"] = rel
    log(f"  d. step {CAPTURE_STEPS} with lambda_distortion "
        f"{CAPTURE_DISTORTION}: distortion {kept['distortion']:.6e}, "
        f"float64 per-ray double sum {ref:.6e}, relative difference "
        f"{rel:.2e}; loss {metrics[-1]['loss']:.5f}")
    if rel > 1e-4 or not np.isfinite(metrics[-1]["loss"]) \
            or system.skipped_updates:
        fail("the distortion term on the card disagrees with the "
             "float64 brute force")
    del kept

    # e. the test view and one predict frame
    torch.cuda.synchronize()
    scatter.scatter_add.launches = 0
    gather.gather_rows.launches = 0
    t0 = time.perf_counter()
    test = system.render_image(state, splits["test"], 0)
    test_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame = system.render_image(state, splits["predict"], 0)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    k1["render_launches"] = scatter.scatter_add.launches
    g1["render_launches"] = gather.gather_rows.launches
    gt = splits["test"].all_images[0].reshape(-1, 3)
    mse = float(np.mean((test["comp_rgb_full"] - gt) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-30))
    dropped = int((~test["ray_included"]).sum())
    h, w = splits["test"].h, splits["test"].w
    log(f"  e. test view 0 ({w}x{h}) in {test_s:.1f} s: PSNR "
        f"{psnr:.3f} dB, dropped rays {dropped}; predict frame 0 in "
        f"{pred_s:.1f} s, dropped rays "
        f"{int((~frame['ray_included']).sum())}; K1/G1 launches "
        f"{k1['render_launches']}/{g1['render_launches']}")
    k1["test_psnr"] = psnr
    if not np.isfinite(psnr) or \
            frame["comp_rgb_full"].shape != (h * w, 3) or \
            not np.isfinite(frame["comp_rgb_full"]).all():
        fail(f"capture renders: PSNR {psnr}, predict frame "
             f"{frame['comp_rgb_full'].shape}")
    if g1["render_launches"] == 0 or k1["render_launches"] != 0:
        fail(f"the capture's renders launched K1 "
             f"{k1['render_launches']}, G1 {g1['render_launches']} times")
    del system, state
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return k1, g1, written


# phase 14: what a user's capture or config names.  (b) phase 13's
# capture as baseline JPEG, loaded at img_downscale 2, 16 neus_colmap
# steps; (c) neus_sphere_full with AdamW, a chained schedule and variance
# modulation, 24 steps; (d) LPIPS with seeded synthetic VGG16 weights
JPEG_FIXTURES = os.path.join("tests", "data", "jpeg")
JPEG_MIN_PSNR = 35.0  # dB: each decoded JPEG against its PNG original
JPEG_STEPS, JPEG_ENCODERS = 16, 4
WIDE_W = 5000  # a real capture's width (Mip-NeRF 360's full-size images)
MOD_STEPS, MOD_WD = 24, 0.01
MOD_SCHEDULER = {"name": "ChainedScheduler", "schedulers": [
    {"name": "ConstantLR", "args": {"factor": 0.5, "total_iters": 4}},
    {"name": "ExponentialLR", "args": {"gamma": 0.999}}]}
MOD_VARIANCE = {"modulate": True, "mod_start_steps": 8,
                "reach_max_steps": 64, "max_inv_s": 2048.0}
# LPIPS card against CPU: float32 convs (TF32 off) in other algorithms
LPIPS_RTOL = 1e-5
LPIPS_CONVS = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256),
               (256, 256), (256, 256), (256, 512), (512, 512), (512, 512),
               (512, 512), (512, 512), (512, 512)]
LPIPS_LINS = [64, 128, 256, 512, 512]

# the JPEG writer of 14b: baseline, 4:2:0, JFIF, a restart marker after
# every MCU row; Huffman codes of Annex K's code-length profiles with the
# symbols in order of their count in the image
JPEG_QUALITY, JPEG_RESTART_ROWS = 95, 1
_Q_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
           14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
           18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
           92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
           103, 99]
_Q_CHROMA = [17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 \
    + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38
# codes per length 1..16 (Annex K.3's luminance DC and AC tables)
_DC_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_AC_COUNTS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]


def _zigzag():
    """The natural (row-major) index of each zigzag position."""
    return np.array(sorted(range(64), key=lambda n: (
        n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else n % 8)))


def _category(v):
    """The bits of |v| (JPEG's size category), int64."""
    a = np.abs(v).astype(np.int64)
    s = np.zeros_like(a)
    while (a >> s).any():
        s += (a >> s) > 0
    return s


def _huffman(count, symbols, lengths):
    """(DHT payload, code [256], length [256]) of the canonical code with
    ``lengths[l - 1]`` codes of l bits, ``symbols`` in order of
    ``count``."""
    order = sorted(symbols, key=lambda s: (-int(count[s]), s))
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    c, k = 0, 0
    for n_bits, n in enumerate(lengths, start=1):
        for _ in range(n):
            code[order[k]], length[order[k]] = c, n_bits
            c, k = c + 1, k + 1
        c <<= 1
    return bytes(lengths) + bytes(order), code, length


def encode_jpeg(rgb, quality=JPEG_QUALITY, restart_rows=JPEG_RESTART_ROWS):
    """uint8 [H, W, 3] -> a baseline JPEG file (bytes): JFIF YCbCr at
    4:2:0, Annex K's quantisation tables scaled as IJG's at ``quality``,
    a restart interval of ``restart_rows`` MCU rows; in numpy."""
    import struct

    h, w, _ = rgb.shape
    mh, mw = -(-h // 16), -(-w // 16)
    x = np.pad(rgb.astype(np.float64), ((0, mh * 16 - h), (0, mw * 16 - w),
                                        (0, 0)), mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    for c in (1, 2):  # 2 x 2 means
        planes[c] = planes[c].reshape(mh * 8, 2, mw * 8, 2).mean((1, 3))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    tables = [np.clip((np.asarray(t) * scale + 50) // 100, 1, 255)
              for t in (_Q_LUMA, _Q_CHROMA)]
    k = np.arange(8)
    dct = np.sqrt(np.where(k == 0, 1.0, 2.0) / 8)[:, None] * np.cos(
        (2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    zz = _zigzag()

    def blocks(plane, q):
        """[rows, cols] -> quantised zigzag coefficients [by, bx, 64]."""
        p = np.clip(np.round(plane), 0, 255) - 128.0
        p = p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).transpose(
            0, 2, 1, 3)
        coef = (dct @ p @ dct.T).reshape(p.shape[0], p.shape[1], 64)
        return np.round(coef / q.reshape(64)).astype(np.int64)[..., zz]

    luma_blocks = blocks(planes[0], tables[0]).reshape(
        mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mh, mw, 4, 64)
    coefs = np.concatenate(
        [luma_blocks] + [blocks(planes[c], tables[1])[:, :, None]
                         for c in (1, 2)], 2).reshape(-1, 64)
    n_mcu, ri, n_b = mh * mw, restart_rows * mw, coefs.shape[0]
    luma = np.tile([True] * 4 + [False] * 2, n_mcu)

    # DC differences per component, restarted at every interval
    dc = coefs[:, 0].reshape(n_mcu, 6)
    diff = np.empty_like(dc)
    for cols in ([0, 1, 2, 3], [4], [5]):
        seq = dc[:, cols].reshape(-1)
        prev = np.roll(seq, 1)
        prev[np.arange(seq.size) % (len(cols) * ri) == 0] = 0
        diff[:, cols] = (seq - prev).reshape(n_mcu, len(cols))
    diff = diff.reshape(-1)
    # AC: (zero run, size) of each nonzero coefficient, a ZRL per 16
    # zeros, an EOB after a block's last nonzero before position 63
    bi, kk = np.nonzero(coefs[:, 1:])
    kk = kk + 1
    prev_k = np.where(np.r_[True, bi[1:] != bi[:-1]], 0, np.r_[0, kk[:-1]])
    run = kk - prev_k - 1
    n_zrl = run // 16
    ac_v = coefs[bi, kk]
    last = np.zeros(n_b, np.int64)
    last[bi] = kk  # in order: the last write is the block's last nonzero
    eob = np.nonzero(last < 63)[0]
    dc_s, ac_s = _category(diff), _category(ac_v)
    ac_sym = ((run % 16) << 4) | ac_s
    zrl_b = np.repeat(bi, n_zrl)
    zrl_slot = np.repeat(kk * 4, n_zrl) + np.arange(zrl_b.size) \
        - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)

    dht, dc_tab, ac_tab = b"", [], []
    ac_symbols = [0x00, 0xF0] + [(rr << 4) | s for rr in range(16)
                                 for s in range(1, 11)]
    for t, sel in enumerate((luma, ~luma)):  # 0: luma, 1: chroma
        payload, code, length = _huffman(
            np.bincount(dc_s[sel], minlength=256), range(12), _DC_COUNTS)
        dht += bytes([t]) + payload
        dc_tab.append((code, length))
        count = np.bincount(ac_sym[sel[bi]], minlength=256)
        count[0x00] += int(sel[eob].sum())
        count[0xF0] += int(sel[zrl_b].sum())
        payload, code, length = _huffman(count, ac_symbols, _AC_COUNTS)
        dht += bytes([0x10 | t]) + payload
        ac_tab.append((code, length))

    def emit(tabs, blk, sym, s, v):
        """(code << size | extra bits, code length + size) per symbol."""
        lum = luma[blk]
        code = np.where(lum, tabs[0][0][sym], tabs[1][0][sym])
        length = np.where(lum, tabs[0][1][sym], tabs[1][1][sym])
        return (code << s) | np.where(v < 0, v + (1 << s) - 1, v), length + s

    zero = np.zeros(zrl_b.size + eob.size, np.int64)
    parts = [emit(dc_tab, np.arange(n_b), dc_s, dc_s, diff),
             emit(ac_tab, zrl_b, zero[:zrl_b.size] + 0xF0, zero[:zrl_b.size],
                  zero[:zrl_b.size]),
             emit(ac_tab, bi, ac_sym, ac_s, ac_v),
             emit(ac_tab, eob, zero[:eob.size], zero[:eob.size],
                  zero[:eob.size])]
    blk = np.concatenate([np.arange(n_b), zrl_b, bi, eob])
    slot = np.concatenate([np.zeros(n_b, np.int64), zrl_slot, kk * 4 + 3,
                           np.full(eob.size, 300)])
    order = np.argsort(blk * 512 + slot, kind="stable")
    vals = np.concatenate([p[0] for p in parts])[order]
    lens = np.concatenate([p[1] for p in parts])[order]
    # each interval padded with 1-bits to a whole byte, then bit-packed
    interval = (blk[order] // 6) // ri
    n_int = -(-n_mcu // ri)
    bits = np.bincount(interval, weights=lens, minlength=n_int).astype(
        np.int64)
    pad = (-bits) % 8
    ends = np.searchsorted(interval, np.arange(n_int), side="right")
    vals = np.insert(vals, ends, (1 << pad) - 1).astype(np.uint32)
    lens = np.insert(lens, ends, pad).astype(np.int32)
    rep = np.repeat(np.arange(lens.size, dtype=np.int32), lens)
    shift = (np.cumsum(lens, dtype=np.int64)[rep] - 1
             - np.arange(rep.size, dtype=np.int64)).astype(np.uint32)
    stream = np.packbits(((vals[rep] >> shift) & 1).astype(np.uint8))
    scan = bytearray()
    for i, chunk in enumerate(np.split(stream,
                                       np.cumsum((bits + pad) // 8)[:-1])):
        if i:
            scan += bytes([0xFF, 0xD0 + (i - 1) % 8])
        scan += np.insert(chunk, np.nonzero(chunk == 0xFF)[0] + 1,
                          0).tobytes()  # byte stuffing

    def segment(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
            + payload

    dqt = b"".join(bytes([t]) + bytes(tables[t].astype(np.uint8)[zz])
                   for t in (0, 1))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    return (b"\xff\xd8"
            + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + segment(0xDB, dqt) + segment(0xC0, sof) + segment(0xC4, dht)
            + segment(0xDD, struct.pack(">H", ri))
            + segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
            + bytes(scan) + b"\xff\xd9")


def _psnr_u8(a, b):
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return 10.0 * np.log10(255.0 ** 2 / max(mse, 1e-30))


def jpeg_fixture_phase():
    """14a: every committed fixture decoded by the port, its bytes'
    SHA-256 and shape held to Pillow's in the manifest."""
    import hashlib

    from rise_sdf_tpu_torch.utils import jpeg

    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    t0 = time.perf_counter()
    jpeg.load_library()
    build_s = time.perf_counter() - t0
    bad, t0 = [], time.perf_counter()
    for name, want in sorted(manifest["files"].items()):
        img = jpeg.read_jpeg(os.path.join(JPEG_FIXTURES, name))
        if list(img.shape) != want["shape"] or hashlib.sha256(
                img.tobytes()).hexdigest() != want["sha256"]:
            bad.append(name)
    n = len(manifest["files"])
    log(f"  a. decoder built (g++) and loaded in {build_s:.1f} s; "
        f"{n - len(bad)} of {n} fixtures bit-equal to Pillow "
        f"{manifest['pillow']} (libjpeg-turbo {manifest['libjpeg_turbo']}) "
        f"by the manifest's SHA-256, decoded in "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    if bad or n < 10:
        fail(f"JPEG fixtures not bit-equal to Pillow's decode: {bad}")
    return n


def jpeg_capture_phase(torch, scatter, gather, root, written):
    """14b: phase 13's capture under ``root`` as baseline JPEG in a
    sibling directory, decoded, loaded and trained on.  Returns the
    record: decode ms, PSNRs, steps/s, launches."""
    from concurrent.futures import ThreadPoolExecutor

    from rise_sdf_tpu_torch import datasets, launch, presets, systems
    from rise_sdf_tpu_torch.utils.image import resize_like_pil
    from rise_sdf_tpu_torch.utils.jpeg import read_jpeg

    views = written["views"]
    jroot = root.rstrip(os.sep) + "_jpeg"
    shutil.rmtree(jroot, ignore_errors=True)
    os.makedirs(os.path.join(jroot, "images"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(JPEG_ENCODERS) as ex:
        files = list(ex.map(lambda v: encode_jpeg(v["png"]), views))
    enc_s = time.perf_counter() - t0
    names = [f"{i:03d}.jpg" for i in range(len(views))]
    for name, buf in zip(names, files):
        with open(os.path.join(jroot, "images", name), "wb") as f:
            f.write(buf)
    write_colmap_sparse(os.path.join(jroot, "sparse", "0"), CAPTURE_W,
                        CAPTURE_H, CAPTURE_FOCAL, written["w2c"], names,
                        written["colmap_points"])
    decoded, ms, psnrs = [], [], []
    for name, v in zip(names, views):
        t0 = time.perf_counter()
        img = read_jpeg(os.path.join(jroot, "images", name))
        ms.append(1e3 * (time.perf_counter() - t0))
        decoded.append(img)
        psnrs.append(_psnr_u8(img, v["png"]))
    rec = {"decode_ms": float(np.median(ms)),
           "min_psnr_db": float(min(psnrs)),
           "mb_per_image": sum(map(len, files)) / len(files) / 1e6}
    wide_h = round(WIDE_W * CAPTURE_H / CAPTURE_W)
    rec["decode_ms_wide"] = rec["decode_ms"] * WIDE_W * wide_h / (
        CAPTURE_W * CAPTURE_H)
    log(f"  b. encoded {len(views)} views as baseline JPEG (4:2:0, quality "
        f"{JPEG_QUALITY}, a restart marker per MCU row; "
        f"{rec['mb_per_image']:.3f} MB each) in {enc_s:.1f} s "
        f"({JPEG_ENCODERS} threads); decode {rec['decode_ms']:.1f} ms per "
        f"{CAPTURE_W}x{CAPTURE_H} image on the host (median of "
        f"{len(ms)}), by pixel count {rec['decode_ms_wide']:.0f} ms at "
        f"{WIDE_W}x{wide_h}; PSNR against the PNG originals "
        f"{min(psnrs):.2f}-{max(psnrs):.2f} dB (at least {JPEG_MIN_PSNR})")
    if min(psnrs) < JPEG_MIN_PSNR:
        fail(f"decoded JPEG capture PSNR {psnrs} below {JPEG_MIN_PSNR} dB")

    cfg = launch.resolve(launch.apply_overrides(
        presets.neus_colmap(), [f"dataset.root_dir={jroot}",
                                f"dataset.img_downscale={CAPTURE_DOWNSCALE}"]))
    t0 = time.perf_counter()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    hold = int(dm.config.get("hold_every", 8))
    wh = (CAPTURE_W // CAPTURE_DOWNSCALE, CAPTURE_H // CAPTURE_DOWNSCALE)
    for name in ("train", "test"):
        split = getattr(dm, name)()
        ids = [i for i in range(len(views)) if (i % hold == 0)
               == (name == "test")]
        for k, i in enumerate(ids):
            want = resize_like_pil(decoded[i], wh).astype(np.float32) / 255
            if not np.array_equal(split.all_images[k], want):
                fail(f"JPEG capture {name} view {i} is not resize_like_pil "
                     "of its decode")
    rec["load_s"] = time.perf_counter() - t0
    log(f"     loaded through the colmap loader in {rec['load_s']:.1f} s, "
        f"every image resize_like_pil of its decode")

    seed = int(cfg["seed"])
    out_dir = os.path.join("exp", "chip_smoke_jpeg")
    system = systems.make(cfg["system"]["name"], cfg, dm,
                          save_dir=os.path.join(out_dir, "save"),
                          device="cuda")
    state = system.init_state(seed)
    state, rate, peak, deltas, losses = _train_window(
        torch, scatter, gather, system, state, JPEG_STEPS, seed)
    rec.update(steps_per_s=rate, k1=sum(d[0] for d in deltas),
               g1=sum(d[1] for d in deltas),
               k1_per_step=sorted({d[0] for d in deltas}),
               g1_per_step=sorted({d[1] for d in deltas}))
    log(f"     neus_colmap on it, {JPEG_STEPS} steps: {rate:.3f} steps/s, "
        f"peak {peak:.2f} GiB, losses {losses[0]:.5f} -> {losses[-1]:.5f}, "
        f"skipped {system.skipped_updates}; K1/G1 launches per step "
        f"{rec['k1_per_step']} / {rec['g1_per_step']}")
    if len(losses) != JPEG_STEPS or not np.all(np.isfinite(losses)) \
            or system.skipped_updates:
        fail(f"neus_colmap on the JPEG capture: losses {losses}, skipped "
             f"{system.skipped_updates}")
    if any(d[0] != 2 or not 2 <= d[1] <= 3 for d in deltas):
        fail(f"a neus_colmap step on the JPEG capture without K1 twice and "
             f"G1 two or three times: {deltas}")
    del system, state
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(jroot, ignore_errors=True)
    return rec


def config_surface_phase(torch, scatter, gather):
    """14c: ``neus_sphere_full`` with AdamW, the chained schedule and
    variance modulation, each step held to a float64 host recurrence;
    then the state saved and loaded.  Returns the record."""
    from rise_sdf_tpu_torch import datasets, systems
    from rise_sdf_tpu_torch.presets import neus_sphere_full

    cfg = neus_sphere_full()
    opt = cfg["system"]["optimizer"]
    opt["name"] = "AdamW"
    opt["args"]["weight_decay"] = MOD_WD
    cfg["system"]["scheduler"] = json.loads(json.dumps(MOD_SCHEDULER))
    cfg["model"]["variance"].update(MOD_VARIANCE)
    mv = cfg["model"]["variance"]
    seed = int(cfg.get("seed", 42))
    out_dir = os.path.join("exp", "chip_smoke_config")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    system = systems.make(cfg["system"]["name"], cfg, dm,
                          save_dir=os.path.join(out_dir, "save"),
                          device="cuda")
    state = system.init_state(seed)
    log(f"  c. neus_sphere_full + AdamW (weight_decay {MOD_WD}), "
        f"ChainedScheduler[ConstantLR 0.5 x 4, ExponentialLR 0.999], "
        f"modulation from step {mv['mod_start_steps']} to "
        f"{mv['max_inv_s']:g} at {mv['reach_max_steps']}: built in "
        f"{time.perf_counter() - t0:.1f} s")
    if not isinstance(system.optimizer, torch.optim.AdamW):
        fail(f"the optimizer is {type(system.optimizer).__name__}")
    groups = system.optimizer.param_groups
    bases = list(system.scheduler.base_lrs)
    iv = [g["name"] for g in groups].index("variance")
    var = system.model.variance

    def factor(s):  # the schedule at update s, in float64
        return (0.5 if s < 4 else 1.0) * 0.999 ** s

    seen = []

    def on_log(step, m):
        seen.append({"step": step, "inv_s": m["inv_s"],
                     "lrs": [g["lr"] for g in groups],
                     "prev": np.float32(var.prev_inv_s.item()),
                     "var": np.float32(var.variance.item())})

    prev0 = np.float32(var.prev_inv_s.item())
    var0 = np.float32(var.variance.item())
    state, rate, peak, deltas, losses = _train_window(
        torch, scatter, gather, system, state, MOD_STEPS, seed, on_log)
    # the float64 host recurrence, step by step from the card's values:
    # inv_s is exp(10 v) of the variance before the step, capped past
    # mod_start_steps by the ramp from the prev_inv_s before the step;
    # prev_inv_s is exp(10 v) of the variance after the step up to
    # mod_start_steps, then decays by (1 - lr_variance * wd), AdamW's
    # step (float32: the buffer times the float32 factor; held to one
    # ulp, the bit-equal steps counted)
    bad, exact, capped = [], 0, 0
    prev, v_before = prev0, var0
    for r in seen:
        s = r["step"]
        if r["lrs"] != [b * factor(s + 1) for b in bases]:
            bad.append(f"step {s}: lr {r['lrs']}")
        raw = float(np.exp(10.0 * np.float64(v_before)))
        want_inv_s = raw
        if s > mv["mod_start_steps"]:
            cap = min(s / mv["reach_max_steps"] * (mv["max_inv_s"]
                                                   - float(prev))
                      + float(prev), mv["max_inv_s"])
            capped += raw > cap
            want_inv_s = min(raw, cap)
            if r["inv_s"] > cap * (1 + 1e-6):
                bad.append(f"step {s}: inv_s {r['inv_s']} above {cap}")
        if abs(r["inv_s"] - want_inv_s) > 5e-7 * want_inv_s:
            bad.append(f"step {s}: inv_s {r['inv_s']}, host {want_inv_s}")
        if s <= mv["mod_start_steps"]:
            want = float(np.exp(10.0 * np.float64(r["var"])))
            ok = abs(float(r["prev"]) - want) <= 5e-7 * want
        else:
            want = prev * np.float32(1.0 - bases[iv] * factor(s) * MOD_WD)
            ok = abs(float(r["prev"]) - float(want)) <= float(
                np.spacing(want))
            exact += bool(r["prev"] == want)
        if not ok:
            bad.append(f"step {s}: prev_inv_s {r['prev']}, host {want}")
        prev, v_before = r["prev"], r["var"]
    rec = {"steps_per_s": rate, "k1": sum(d[0] for d in deltas),
           "g1": sum(d[1] for d in deltas),
           "k1_per_step": sorted({d[0] for d in deltas}),
           "g1_per_step": sorted({d[1] for d in deltas}),
           "prev_inv_s": [float(seen[0]["prev"]), float(seen[-1]["prev"])],
           "exact_steps": exact, "capped_steps": capped}
    log(f"     {MOD_STEPS} steps: {rate:.3f} steps/s, peak {peak:.2f} GiB, "
        f"losses {losses[0]:.5f} -> {losses[-1]:.5f}, skipped "
        f"{system.skipped_updates}; K1/G1 launches per step "
        f"{rec['k1_per_step']} / {rec['g1_per_step']}; every group's lr "
        f"equal to base x schedule; prev_inv_s {rec['prev_inv_s'][0]:.4f} "
        f"-> {rec['prev_inv_s'][1]:.4f} ({exact} of "
        f"{MOD_STEPS - 1 - mv['mod_start_steps']} decay steps bit-equal to "
        f"the recurrence), inv_s <= the cap ({capped} steps capped)")
    if bad or len(seen) != MOD_STEPS:
        fail(f"config surface against the host recurrence: {bad[:6]}")
    if len(losses) != MOD_STEPS or not np.all(np.isfinite(losses)) \
            or system.skipped_updates:
        fail(f"config surface: losses {losses}, skipped "
             f"{system.skipped_updates}")
    if any(d[0] != 1 or not 1 <= d[1] <= 2 for d in deltas):
        fail(f"a config-surface step without K1 once and G1 once or twice: "
             f"{deltas}")
    ckpt = os.path.join(out_dir, "state.ckpt.npz")
    t0 = time.perf_counter()
    system.save_checkpoint(state, ckpt)
    other = systems.make(cfg["system"]["name"], cfg, dm,
                         save_dir=os.path.join(out_dir, "save"),
                         device="cuda")
    loaded = other.load_checkpoint(ckpt)
    diff = _same_state(torch, system, other, state, loaded)
    log(f"     saved and loaded in {time.perf_counter() - t0:.1f} s: "
        f"prev_inv_s {float(other.model.variance.prev_inv_s):.6f}; "
        f"{len(diff)} tensors differ (params, buffers, AdamW moments and "
        f"counts, lrs)")
    if diff:
        fail(f"the AdamW / modulation state does not load back: {diff}")
    del system, other, state, loaded
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def write_lpips_weights(path, seed=0):
    """Seeded synthetic VGG16-LPIPS weights (fan-in scaled) in the keys of
    ``scripts/convert_lpips_weights.py``: ``conv{i}_w`` HWIO,
    ``conv{i}_b``, ``lin{k}``."""
    rng = np.random.RandomState(seed)
    w = {}
    for i, (cin, cout) in enumerate(LPIPS_CONVS):
        w[f"conv{i}_w"] = (rng.randn(3, 3, cin, cout)
                           * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        w[f"conv{i}_b"] = (rng.randn(cout) * 0.01).astype(np.float32)
    for k, c in enumerate(LPIPS_LINS):
        w[f"lin{k}"] = (np.abs(rng.randn(c)) / c).astype(np.float32)
    np.savez(path, **w)


def lpips_phase(torch, scatter, gather, trained, state, pair):
    """14d: LPIPS on phase 9's view-0 pair, card against CPU, and the
    test protocol on one view with the weights set.  Returns the
    record."""
    from rise_sdf_tpu_torch import measure
    from rise_sdf_tpu_torch.systems import lpips

    pred, gt = pair
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vgg16_lpips.npz")
        write_lpips_weights(path)
        os.environ["RISE_SDF_LPIPS_WEIGHTS"] = path
        lpips.reset_cache()
        try:
            card = lpips.lpips(pred, gt, device="cuda")  # cuDNN warm-up
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                card = lpips.lpips(pred, gt, device="cuda")
                times.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            cpu = lpips.lpips(pred, gt, device="cpu")
            rec.update(card=card, cpu=cpu, ms=float(np.median(times)),
                       cpu_ms=1e3 * (time.perf_counter() - t0),
                       rel_err=abs(card - cpu) / max(abs(cpu), 1e-30))
            log(f"  d. LPIPS (synthetic VGG16 weights) of phase 9's view 0 "
                f"({pred.shape[1]}x{pred.shape[0]}): card {card:.8f} in "
                f"{rec['ms']:.2f} ms (median of 5, TF32 off), CPU "
                f"{cpu:.8f} in {rec['cpu_ms']:.0f} ms; relative difference "
                f"{rec['rel_err']:.2e} (at most {LPIPS_RTOL:g})")
            if not np.isfinite(card) or rec["rel_err"] > LPIPS_RTOL:
                fail("LPIPS on the card disagrees with the CPU")
            test_system = measure.test_system(trained, n_images=1)
            run = measure.run_test(test_system, state, log=log)
        finally:
            del os.environ["RISE_SDF_LPIPS_WEIGHTS"]
            lpips.reset_cache()
    rec["gifs"] = check_test_gifs(os.path.join("exp", "test_protocol"),
                                  int(state["step"]), 1, "14d")
    shutil.rmtree(os.path.join("exp", "test_protocol"), ignore_errors=True)
    want = ["phys_lpips", "albedo_lpips"] + [
        f"relight_lpips_{light}" for light in test_system.relight_list]
    got = {k: run["metrics"].get(k) for k in want}
    rec.update(test_s=run["s_per_view"], g1=run["g1_launches"],
               k1=run["k1_launches"], metrics=got)
    log(f"     test protocol on one view with the weights: "
        f"{run['s_per_view']:.1f} s, {json.dumps(got)}; G1/K1 launches "
        f"{run['g1_launches']}/{run['k1_launches']}")
    if not all(v is not None and np.isfinite(v) for v in got.values()):
        fail(f"test protocol LPIPS metrics {got}")
    if run["g1_launches"] == 0 or run["k1_launches"]:
        fail(f"the test protocol launched G1 {run['g1_launches']}, K1 "
             f"{run['k1_launches']} times")
    return rec


# phase 15: the JAX package's remaining appearance library.  15b's
# shading points are phase 9's view 0 (800x800) with materials from
# PBR_SEED, shaded in chunks of PBR_CHUNK points; the CPU repeats chunk
# PBR_CPU_CHUNK (image rows 400-479).  The heads of the flagship run in
# bf16 with float32 products, whose rounding the card and the CPU reach
# by different sums, so 15b holds rgb_phys to PBR_RGB_TOL of
# max(1, its largest entry).  Sampled directions take square roots of
# differences near 0 (the disk's rim, grazing views), which amplify
# float32 rounding: on the CPU the samplers stay within DIR_TOL of
# float64, and within 1e-5 on all but DIR_SHARE of the directions
# (tests/test_torch_warp.py), the bounds 15b holds the card's
# directions to.  15d compares in float64, where the same amplification
# (normalising short vectors, a resampled point moving by the CDF's
# rounding over a dead bin's ~1e-5 of the mass, the drivers' scan over
# a chunk's buffer) stays far below OPS_TOL, which float32 exceeds.
COLOR_STEPS = 16
PBR_SEED = 15
PBR_CHUNK = 64000
PBR_CPU_CHUNK = 5
PBR_RGB_TOL = 2e-3
DIR_TOL, DIR_SHARE = 1e-3, 5e-3
LIGHT_RES = (128, 256)
LIGHT_DRAWS = 1 << 20
LIGHT_INV_PDF_TOL = 0.02
# the lat-long projection samples the 512^2 base bilinearly at
# directions from sin and cos, whose rounding (2 ulp on the card) moves a
# sample by ~1e-4 of a texel: 2.8e-5 of the pdf's largest value
LIGHT_CDF_TOL = 1e-4
OPS_SEED = 16
OPS_POINTS = 800 * 800
OPS_TOL = 1e-9
DRIVER_CHUNK = 4096
WARP_SAMPLERS = [
    ("square_to_cosine_hemisphere", ["u"]),
    ("sample_uniform_disk_concentric", ["u"]),
    ("sample_uniform_cylinder", ["u"]),
    ("sample_uniform_hemisphere", ["u", "n"]),
    ("sample_lambertian_surface", ["u", "n"]),
    ("sample_specular_mirror", [None, "n", "wi"]),
    ("sample_sggx_vndf", ["u", "n", "wi", "alpha"]),
    ("sample_diffuse_sggx", ["u", "u2", "n", "wi", "alpha"]),
    ("sample_specular_sggx", ["u", "n", "wi", "alpha"]),
    ("sample_ggx_vndf", ["wl", "alpha", "u"]),
]


def check_test_gifs(save, step, views, phase):
    """15e: the test run's ``it{step}-test.gif`` and
    ``it{step}-test-pbr.gif`` under ``save`` read back by the port's
    decoder: ``views`` frames, the first equal to the port's quantised
    ``0.png`` (``0-pbr.png``).  Returns each file's frames, bytes, first
    frame's quantisation error and decode seconds."""
    from rise_sdf_tpu_torch.utils import gif
    from rise_sdf_tpu_torch.utils.png import read_png

    rec = {}
    for name, suffix in (("test", ""), ("test-pbr", "-pbr")):
        path = os.path.join(save, f"it{step}-{name}.gif")
        if not os.path.exists(path):
            fail(f"phase {phase}: no {path}")
        t0 = time.perf_counter()
        frames, delays = gif.read_gif(path)
        dec_s = time.perf_counter() - t0
        png = read_png(os.path.join(save, f"it{step}-test", f"0{suffix}.png"))
        idx, pal = gif.quantize(png)
        if len(frames) != views or frames[0].shape != png.shape \
                or not np.array_equal(frames[0], pal[idx]):
            fail(f"phase {phase}: {path} has {len(frames)} frames (want "
                 f"{views}) or its first is not 0{suffix}.png quantised")
        err = np.abs(frames[0].astype(np.int64) - png)
        rec[name] = {"frames": len(frames), "bytes": os.path.getsize(path),
                     "first_max_err": int(err.max()),
                     "first_mean_err": float(err.mean()),
                     "decode_s": dec_s}
        log(f"  e. phase {phase}'s it{step}-{name}.gif: {len(frames)} frames "
            f"of {png.shape[1]}x{png.shape[0]}, {rec[name]['bytes']} bytes, "
            f"delay {delays[0]}/100 s, decoded in {dec_s:.1f} s; frame 0 "
            f"against 0{suffix}.png: max {err.max()}, mean {err.mean():.2f} "
            f"levels (256-colour quantisation)")
    return rec


def color_phase(torch, scatter, gather):
    """15a: NeuS at ``neus_sphere_color_full`` from a fresh init for
    ``COLOR_STEPS`` steps, then one validation view."""
    from rise_sdf_tpu_torch import datasets, systems
    from rise_sdf_tpu_torch.presets import neus_sphere_color_full

    cfg = neus_sphere_color_full()
    seed = int(cfg["seed"])
    out_dir = os.path.join("exp", "chip_smoke_color")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    system = systems.make(cfg["system"]["name"], cfg, dm, save_dir=out_dir,
                          device="cuda")
    if type(system.model.texture).__name__ != "VolumeColor":
        fail(f"the texture is {type(system.model.texture).__name__}")
    state = system.init_state(seed)
    built = time.perf_counter() - t0
    state, rate, peak, deltas, losses = _train_window(
        torch, scatter, gather, system, state, COLOR_STEPS, seed)
    torch.cuda.synchronize()
    scatter.scatter_add.launches = 0
    gather.gather_rows.launches = 0
    e1 = e1_launches()
    t0 = time.perf_counter()
    val = system.validate(state, n_images=1)
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    val_k1, val_g1 = scatter.scatter_add.launches, gather.gather_rows.launches
    val_e1 = e1_launches() - e1
    rec = {"steps_per_s": rate, "peak_gib": peak,
           "k1": sum(d[0] for d in deltas), "g1": sum(d[1] for d in deltas),
           "k1_per_step": sorted({d[0] for d in deltas}),
           "g1_per_step": sorted({d[1] for d in deltas}),
           "psnr": val["psnr"], "validate_s": val_s, "validate_g1": val_g1,
           "validate_e1": val_e1, "validate_k1": val_k1}
    log(f"  a. neus_sphere_color_full (volume-color on the 48 features, "
        f"4 x 128 hidden): built in {built:.1f} s; {COLOR_STEPS} steps at "
        f"{rate:.3f} steps/s, peak {peak:.2f} GiB, losses {losses[0]:.5f} "
        f"-> {losses[-1]:.5f}, skipped {system.skipped_updates}; K1 "
        f"launches {rec['k1']} ({rec['k1_per_step']} per step), G1 "
        f"{rec['g1']} ({rec['g1_per_step']} per step); validate 1 view "
        f"800x800 in {val_s:.1f} s: PSNR {val['psnr']:.3f} dB, G1/E1/K1 "
        f"launches {val_g1}/{val_e1}/{val_k1}")
    if len(losses) != COLOR_STEPS or not np.all(np.isfinite(losses)) \
            or system.skipped_updates:
        fail(f"volume-color NeuS: losses {losses}, skipped "
             f"{system.skipped_updates}")
    if any(d[0] != 1 or d[1] < 1 for d in deltas):
        fail(f"a volume-color step without one K1 and a G1 launch: {deltas}")
    if not np.isfinite(val["psnr"]) or val_e1 == 0 or val_k1:
        fail(f"volume-color validation {val}, G1/E1/K1 "
             f"{val_g1}/{val_e1}/{val_k1}")
    del system, state
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def _indirect(model, occ, bake, normals, step):
    """``compute_indirect`` of 15b: the flagship's transmittance along
    the secondary rays (``compute_indirect_radiance`` without
    compaction, so each ray is its own, on the eval bake) and its
    secondary radiance head at the shading point."""
    def fn(o, d):
        tr = model.compute_indirect_radiance(o, d, occ, step, frac=1.0,
                                             bake=bake)[0]
        feat = model.geometry(o, step, with_grad=False,
                              with_feature=True)["feature"]
        return tr, model.texture.secondary_shading(feat, d, normals,
                                                   step=step)
    return fn


def pbr_phase(torch, gather, trained, state, cpu_model, surface):
    """15b: ``volume-pbr`` with ``brdf-ggx`` on phase 9's view 0.  The
    card samples the directions; the CPU samples its own from the same
    uniforms, held to the card's within ``DIR_TOL`` (all but
    ``DIR_SHARE`` of them within 1e-5), then shades chunk
    ``PBR_CPU_CHUNK`` from the card's directions (``measure.
    fixed_directions``), each output held to the card's within
    ``PBR_RGB_TOL``.  The CPU's shading from its own directions is
    logged beside it: a square root near 0 in the sampler turns the two
    devices' last-bit differences into ~1e-4 of a direction, and the
    environment and the GGX pdf of a small roughness into up to ~1e-2
    of radiance, so that chained comparison holds no bound."""
    from rise_sdf_tpu_torch import models
    from rise_sdf_tpu_torch.measure import fixed_directions

    step = int(state["step"])
    rays = torch.from_numpy(surface["rays"])
    n = rays.shape[0]
    o, d = rays[:, :3], rays[:, 3:]
    nrm = torch.from_numpy(surface["normal"]).reshape(n, 3)
    length = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    rng = np.random.default_rng(PBR_SEED)
    host = {
        "pos": o + torch.from_numpy(surface["depth"]).reshape(n, 1) * d,
        "dirs": d,
        # the background's pixels (no surface) face the camera
        "normals": torch.where(length > 0.5, nrm / length.clamp(min=1e-6),
                               -d),
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

    def run(model, x, u, occ, bake, sl):
        return pbr(x["pos"][sl], x["dirs"][sl], x["normals"][sl],
                   x["albedo"][sl], x["rough"][sl], x["metal"][sl],
                   _indirect(model, occ, bake, x["normals"][sl], step),
                   model.emitter, uniforms=tuple(v[sl] for v in u))

    occ = state["occ_binary"]
    with torch.no_grad():
        bake = trained.model.bake_eval_sdf(step)
        torch.cuda.synchronize()
        gather.gather_rows.launches = 0
        t0 = time.perf_counter()
        outs = [run(trained.model, card, u_card, occ, bake,
                    slice(s, s + PBR_CHUNK)) for s in range(0, n, PBR_CHUNK)]
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        g1 = gather.gather_rows.launches
        rgb = torch.cat([x["rgb_phys"] for x in outs])
        sl = slice(PBR_CPU_CHUNK * PBR_CHUNK, (PBR_CPU_CHUNK + 1) * PBR_CHUNK)
        sc = pbr.scatterer
        dirs_card = sc.sample_from_uniforms(
            *(v[sl] for v in u_card), card["normals"][sl], -card["dirs"][sl],
            card["rough"][sl, 0]).cpu()
        dirs_cpu = sc.sample_from_uniforms(
            *(v[sl] for v in u_host), host["normals"][sl], -host["dirs"][sl],
            host["rough"][sl, 0])
        host_bake = bake and {k: v.cpu() if torch.is_tensor(v) else v
                              for k, v in bake.items()}
        t0 = time.perf_counter()
        with fixed_directions(sc, dirs_card):
            cpu = run(cpu_model, host, u_host, occ.cpu(), host_bake, sl)
        cpu_s = time.perf_counter() - t0
        cpu_own = run(cpu_model, host, u_host, occ.cpu(), host_bake, sl)
    dir_diff = (dirs_card - dirs_cpu).abs().amax(-1)
    dir_err = float(dir_diff.max())
    dir_share = float((dir_diff > 1e-5).double().mean())

    def rel_errs(ref):
        return {k: float((outs[PBR_CPU_CHUNK][k].cpu() - ref[k]).abs().max()
                         / max(1.0, float(ref[k].abs().max())))
                for k in ref}

    errs, errs_own = rel_errs(cpu), rel_errs(cpu_own)
    rec = {"points": n, "card_s": card_s, "cpu_points": sl.stop - sl.start,
           "cpu_s": cpu_s, "g1": g1, "dir_max_abs_err": dir_err,
           "dir_share_above_1e-5": dir_share,
           "rel_err": errs, "rel_err_own_dirs": errs_own,
           "rgb_phys_mean": float(rgb.mean()),
           "rgb_phys_max": float(rgb.max())}
    log(f"  b. volume-pbr + brdf-ggx on phase 9's view 0 ({n} shading "
        f"points, materials from seed {PBR_SEED}, the phase-8 emitter, "
        f"compute_indirect = the flagship's compute_indirect_radiance and "
        f"secondary head) in {len(outs)} chunks: card {card_s:.2f} s (G1 "
        f"launches {g1}); rgb_phys mean {rec['rgb_phys_mean']:.4f}, max "
        f"{rec['rgb_phys_max']:.4f}; chunk {PBR_CPU_CHUNK} on the CPU "
        f"({rec['cpu_points']} points, the same uniforms): its own "
        f"directions max |card - CPU| {dir_err:.2e} (at most {DIR_TOL:g}), "
        f"{dir_share:.2e} of them beyond 1e-5 (at most {DIR_SHARE:g}); "
        f"shaded from the card's directions in {cpu_s:.1f} s, outputs max "
        f"|card - CPU| / max(1, max |CPU|) {json.dumps(errs)} (at most "
        f"{PBR_RGB_TOL:g}); from its own directions (no bound: float32 "
        f"conditioning) {json.dumps(errs_own)}")
    finite = bool(torch.isfinite(rgb).all())
    if not finite or g1 == 0:
        fail(f"volume-pbr on the card: finite {finite}, G1 launches {g1}")
    if dir_err > DIR_TOL or dir_share > DIR_SHARE \
            or max(errs.values()) > PBR_RGB_TOL:
        fail("volume-pbr on the card disagrees with the CPU")
    return rec


def light_phase(torch, trained, cpu_model):
    """15c: the learned emitter's CDFs and ``LIGHT_DRAWS`` importance
    samples, card against CPU on the same uniforms and state."""
    em, em_cpu = trained.model.emitter, cpu_model.emitter
    gen = torch.Generator().manual_seed(OPS_SEED)
    u = (torch.rand(LIGHT_DRAWS, generator=gen),
         torch.rand(LIGHT_DRAWS, generator=gen))
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = em.update_pdf(LIGHT_RES)
        torch.cuda.synchronize()
        pdf_ms = 1e3 * (time.perf_counter() - t0)
        st_cpu = em_cpu.update_pdf(LIGHT_RES)
        state_err = {k: float((st[k].cpu() - st_cpu[k]).abs().max()
                              / st_cpu[k].abs().max()) for k in st}
        u_card = tuple(v.cuda() for v in u)
        em.sample(st, uniforms=u_card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dirs = em.sample(st, uniforms=u_card)
        torch.cuda.synchronize()
        sample_ms = 1e3 * (time.perf_counter() - t0)
        pdf = em.pdf(st, dirs)
        inv = float(torch.mean(1.0 / pdf.double()))
        st_host = {k: v.cpu() for k, v in st.items()}
        dir_err = float((dirs.cpu() - em_cpu.sample(st_host, uniforms=u))
                        .abs().max())
        pdf_cpu = em_cpu.pdf(st_host, dirs.cpu())
    rel = (pdf.cpu() - pdf_cpu).abs() / pdf_cpu
    flips = int((rel > 1e-5).sum())
    rec = {"update_pdf_ms": pdf_ms, "sample_ms": sample_ms,
           "state_rel_err": state_err, "dir_max_abs_err": dir_err,
           "pdf_rel_err": float(rel[rel <= 1e-5].max()), "pdf_bin_flips":
           flips, "mean_inv_pdf_over_4pi": inv / (4 * np.pi)}
    log(f"  c. the learned light ({em.base_res}^2): update_pdf at "
        f"{LIGHT_RES} in "
        f"{pdf_ms:.2f} ms, {LIGHT_DRAWS} draws in {sample_ms:.2f} ms; card "
        f"against CPU: CDFs {json.dumps(state_err)} (relative, at most "
        f"{LIGHT_CDF_TOL:g}), directions on the same state {dir_err:.2e} "
        f"(at most 1e-5), "
        f"pdf {rec['pdf_rel_err']:.2e} relative with {flips} draws in "
        f"another texel (at most {LIGHT_DRAWS // 10000}); mean 1/pdf = "
        f"{rec['mean_inv_pdf_over_4pi']:.5f} x 4 pi")
    if max(state_err.values()) > LIGHT_CDF_TOL or dir_err > 1e-5 \
            or rec["pdf_rel_err"] > 1e-5 or flips > LIGHT_DRAWS // 10000:
        fail("the emitter's sampling on the card disagrees with the CPU")
    if abs(rec["mean_inv_pdf_over_4pi"] - 1) > LIGHT_INV_PDF_TOL:
        fail("the mean of 1/pdf is not 4 pi")
    return rec


def _unit(rng, n, upper=False):
    v = rng.normal(size=(n, 3))
    if upper:
        v[:, 2] = np.abs(v[:, 2]) + 0.05
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _driver_field(torch):
    def fn(ts, te, ridx):
        t = 0.5 * (ts + te)
        n = ts.shape[0]
        one = torch.ones_like(t)
        return {"rgb": torch.stack([torch.sin(t) * 0.5 + 0.5,
                                    torch.cos(t) * 0.5 + 0.5, 0.3 * one], -1),
                "alpha": 0.02 + 0.01 * torch.sin(7 * t),
                "normal": torch.stack([0 * one, 0 * one, one], -1),
                "albedo": torch.full((n, 3), 0.6, dtype=ts.dtype,
                                     device=ts.device),
                "roughness": 0.4 * one, "metallic": 0.2 * one,
                "sdf": t - 1.0,
                "sdf_grad": torch.stack([one, 0 * one, 0 * one], -1)}
    return fn


def ops_phase(torch):
    """15d: the warp samplers and the four ops at one 800^2 view's size,
    card against CPU in float64 (see OPS_TOL)."""
    from rise_sdf_tpu_torch.ops import grid_sample, march, \
        rendering_drivers, renderutils_misc, resample, warp

    n = OPS_POINTS
    rng = np.random.default_rng(OPS_SEED)
    wi = _unit(rng, n)
    nrm = _unit(rng, n)
    wi[: n // 2] *= np.sign(np.sum(wi[: n // 2] * nrm[: n // 2], -1))[:, None]
    host = {"u": rng.uniform(size=(n, 2)), "u2": rng.uniform(size=(n, 2)),
            "n": nrm, "wi": wi, "wl": _unit(rng, n, upper=True),
            "alpha": rng.uniform(0.05, 1, n)}
    host = {k: torch.from_numpy(np.asarray(v, np.float64))
            for k, v in host.items()}
    card = {k: v.cuda() for k, v in host.items()}
    errs, ms = {}, {}

    def both(name, fn, args_host, args_card, rel=False):
        """``fn`` on the card against the CPU, every entry within
        OPS_TOL (of max(1, |CPU value|) with ``rel``)."""
        with torch.no_grad():
            fn(*args_card)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*args_card)
            torch.cuda.synchronize()
            ms[name] = 1e3 * (time.perf_counter() - t0)
            want = fn(*args_host)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs[name] = max(float(((g.cpu() - w).abs() / (
            w.abs().clamp(min=1) if rel else 1)).max())
            for g, w in zip(got, want))
        if not errs[name] <= OPS_TOL:
            fail(f"{name} on the card disagrees with the CPU: {errs[name]}")

    for name, keys in WARP_SAMPLERS:
        both(name, getattr(warp, name),
             [host[k] if k else None for k in keys],
             [card[k] if k else None for k in keys])
    # resample: [R, 32] intervals per pixel, 16 new ones
    edges = np.sort(rng.uniform(0, 4, (n, 33)), 1)
    w = rng.exponential(size=(n, 32))
    live = rng.uniform(size=(n, 32)) > 0.2
    rs_host = [torch.from_numpy(np.ascontiguousarray(a))
               for a in (edges[:, :-1], edges[:, 1:], w, live,
                         rng.uniform(size=(n, 16)))]
    both("ray_resampling",
         lambda *a: resample.ray_resampling(*a[:4], 16, u=a[4]),
         rs_host, [a.cuda() for a in rs_host])
    img = torch.from_numpy(rng.standard_normal((800, 800, 3)))
    vol = torch.from_numpy(rng.standard_normal((64, 64, 64, 4)))
    g2 = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 2)))
    g3 = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 3)))
    both("grid_sample_2d", grid_sample.grid_sample_2d, [img, g2],
         [img.cuda(), g2.cuda()])
    both("grid_sample_3d", grid_sample.grid_sample_3d, [vol, g3],
         [vol.cuda(), g3.cuda()])
    pts = [torch.from_numpy(rng.standard_normal((n, 3))) for _ in range(6)]
    both("prepare_shading_normal", renderutils_misc.prepare_shading_normal,
         pts, [p.cuda() for p in pts])
    mat = torch.from_numpy(rng.standard_normal((4, 4)))
    both("xfm_points", renderutils_misc.xfm_points, [pts[0], mat],
         [pts[0].cuda(), mat.cuda()])
    a, b = (torch.from_numpy(rng.uniform(0, 4, (800, 800, 3)))
            for _ in range(2))
    for loss in ("mse", "l1", "smape", "relmse"):
        for tm in ("none", "log_srgb"):
            both(f"image_loss_{loss}_{tm}",
                 lambda x, y, loss=loss, tm=tm: renderutils_misc.image_loss(
                     x, y, loss, tm), [a, b], [a.cuda(), b.cuda()],
                 rel=True)
    # the drivers over the view's 640,000 rays, in eval chunks
    z = rng.uniform(-0.35, 0.35, (n, 2))
    dirs = np.concatenate([z, np.ones((n, 1))], -1)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1,
                                                  keepdims=True))
    orig = torch.tensor([[0.0, 0.0, -3.0]], dtype=torch.float64).repeat(n, 1)
    field = _driver_field(torch)

    def drive(o, dd):
        lo = torch.full((3,), -1.5, dtype=o.dtype, device=o.device)
        out = []
        for s in range(0, o.shape[0], DRIVER_CHUNK):
            rays_o, rays_d = o[s:s + DRIVER_CHUNK], dd[s:s + DRIVER_CHUNK]
            r = rays_o.shape[0]
            rs = march.march_rays(rays_o, rays_d, aabb_min=lo, aabb_max=-lo,
                                  step_size=0.1, num_samples=32,
                                  capacity=r * 32, grid_binary=None)
            full = rendering_drivers.rendering_with_normals_mats_sdf_dir(
                rs, field, r, rays_d, render_bkgd=torch.ones(
                    3, dtype=o.dtype, device=o.device))
            sec = rendering_drivers.secondary_rendering(rs, field, r)
            out.append(torch.cat([full[k] for k in (
                "comp_rgb", "comp_normal", "comp_albedo", "comp_roughness",
                "comp_metallic", "opacity")] + [sec["depth"],
                                                sec["transmittance"]], -1))
        return torch.cat(out)

    both("rendering_drivers", drive, [orig, dirs], [orig.cuda(), dirs.cuda()])
    log(f"  d. {n} points / rays in float64, card against CPU, max "
        f"|difference| (at most {OPS_TOL:g}; the losses relative; the "
        f"drivers in chunks of {DRIVER_CHUNK} rays); card ms:")
    for k in errs:
        log(f"     {k}: {errs[k]:.2e}, {ms[k]:.2f} ms")
    return {"max_abs_err": errs, "card_ms": ms}


def appearance_phase(torch, scatter, gather, trained, state, surface,
                     gifs):
    """Phase 15 (module docstring).  Returns its record."""
    from rise_sdf_tpu_torch import models

    rec = {"color": color_phase(torch, scatter, gather)}
    cpu_model = models.make(trained.config["model"]["name"],
                            trained.config["model"])
    cpu_model.load_state_dict(trained.model.state_dict())
    cpu_model.requires_grad_(False)
    rec["pbr"] = pbr_phase(torch, gather, trained, state, cpu_model, surface)
    rec["light"] = light_phase(torch, trained, cpu_model)
    del cpu_model
    rec["ops"] = ops_phase(torch)
    rec["gifs"] = gifs
    torch.cuda.empty_cache()
    return rec


# phase 16: the sphere-traced eval.  (a) the tiny split config on 128
# fan rays (tests/test_sphere_trace.py's) in float64; (b) phase 6's bench
# run, whose sphere row renders the 800x800 headline scene by sphere
# tracing; (c) phase 8's parameters, sharp, at split_mixed_occ_test_full
# with eval_mode sphere_trace, one 800x800 test view in both modes.
SURFACE_RAYS, SURFACE_VIEWS = 128, 1
# 16c's and 10e's test views: cut from the preset's 800 x 800 for time
SMALL_VIEW_WH = (400, 400)


def surface_small_phase(torch, gather, scatter):
    """16a: ``forward_surface`` and ``forward_surface_multi`` (the learned
    light and a relight light with the third bounce) at the tiny split
    config, stage 1, variance 0.9, in float64, under full, shell and
    absent occupancy: card against CPU.  Returns G1's and K1's launches
    on the card."""
    import copy

    from rise_sdf_tpu_torch import models
    from rise_sdf_tpu_torch.presets import tiny_split_config

    cfg = tiny_split_config()["model"]
    cfg["variance"]["init_val"] = 0.9  # inv_s ~ 8103
    model = models.make(cfg["name"], cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    z = torch.linspace(-0.3, 0.3, SURFACE_RAYS, dtype=torch.float64)
    d = torch.stack([z * 0.5, z, torch.ones_like(z)], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    rays = torch.cat([torch.tensor([[0.0, 0.0, -4.0]],
                                   dtype=torch.float64).expand_as(d), d], -1)
    res = model.grid_resolution
    g = (torch.arange(res, dtype=torch.float64) + 0.5) / res \
        * 2 * model.radius - model.radius
    centres = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                          -1).reshape(-1, 3)
    cpu = copy.deepcopy(model).double().requires_grad_(False)
    sdf = cpu.geometry.sdf(centres, 20)
    occs = {"full": torch.ones(res ** 3, dtype=torch.bool),
            "shell": sdf.abs() < 2 * 2 * model.radius / res, "absent": None}
    runs = {dev: {} for dev in ("cpu", "cuda")}
    launches = {}
    for dev in runs:
        m = cpu if dev == "cpu" else copy.deepcopy(cpu).to(dev)
        gather.gather_rows.launches = 0
        scatter.scatter_add.launches = 0
        mips = [m.emitter.build_mips(), m.emitter.build_mips(
            torch.roll(m.emitter.base * 1.7 + 0.05, 1, -1))]
        for name, occ in occs.items():
            kw = dict(occ_binary=None if occ is None else occ.to(dev),
                      step=20, stage=1, background_color=torch.ones(
                          3, dtype=torch.float64, device=dev))
            outs = [m.forward_surface(rays.to(dev), mips=mips[0], **kw)] \
                + m.forward_surface_multi(rays.to(dev), mips_list=mips,
                                          relight_flags=(False, True), **kw)
            runs[dev][name] = [{k: v.cpu() for k, v in o.items()}
                               for o in outs]
        launches[dev] = (gather.gather_rows.launches,
                         scatter.scatter_add.launches)
    worst, hits, included = 0.0, {}, {}
    for name in occs:
        for j, (c, g_) in enumerate(zip(runs["cpu"][name],
                                        runs["cuda"][name])):
            for k, v in c.items():
                if not v.is_floating_point():
                    if not torch.equal(g_[k], v):
                        fail(f"16a: {k} of render {j} under {name} "
                             f"occupancy differs between card and CPU")
                else:
                    worst = max(worst, float((g_[k] - v).abs().max()))
            if not torch.equal(g_["opacity"] > 0.5, c["opacity"] > 0.5):
                fail(f"16a: the hit masks differ under {name} occupancy")
            miss = c["opacity"][:, 0] <= 0.5
            bg = float((g_["comp_rgb_full"][miss] - 1.0).abs().max())
            if bg > 1e-5:
                fail(f"16a: misses on the card are {bg:.2e} off the "
                     f"background")
        c = runs["cpu"][name][0]
        hits[name] = int((c["opacity"] > 0.5).sum())
        included[name] = int(c["ray_included"].sum())
    g1, k1 = launches["cuda"]
    lights = float((runs["cpu"]["full"][1]["comp_rgb_phys_full"]
                    - runs["cpu"]["full"][2]["comp_rgb_phys_full"])
                   .abs().max())
    log(f"  a. tiny split forward_surface + forward_surface_multi (learned "
        f"+ relight light) in float64 on {SURFACE_RAYS} rays, full / shell "
        f"/ absent occupancy: max |card - CPU| over every channel "
        f"{worst:.2e}; masks and counts equal; hits {hits}, included "
        f"{included}; the lights differ by {lights:.3f}; G1 launches {g1}, "
        f"K1 launches {k1}")
    if not (worst <= 1e-6 and g1 > 0 and k1 == 0 and lights > 1e-3):
        fail("card and CPU disagree on the tiny sphere-traced renders")
    return g1, k1


def surface_render_check(torch, sphere):
    """16b: the bench's sphere row of phase 6 (the 800x800 headline scene
    rendered by ``forward_surface``): finite, misses the exact
    background, G1 launching; its PSNR against the volumetric headline
    image printed.  Returns its record."""
    from rise_sdf_tpu_torch.systems.criterions import psnr

    img, opacity = sphere["image"], sphere["opacity"]
    miss = opacity <= 0.5
    bg = float((img[miss] - 1.0).abs().max()) if bool(miss.any()) else 0.0
    rec = {"rays_per_s": sphere["sphere_trace_rays_per_sec"],
           "unresolved_rays": sphere["sphere_trace_unresolved_rays"],
           "seconds": sphere["sphere_trace_s"],
           "g1_launches": sphere["sphere_trace_g1_launches"],
           "e1_launches": sphere["sphere_trace_e1_launches"],
           "k1_launches": sphere["sphere_trace_k1_launches"],
           "hits": int((~miss).sum()),
           "profile": {k[len("sphere_"):]: sphere[k] for k in (
               "sphere_profile_chunks", "sphere_profile_wall_ms",
               "sphere_profile_device_ms", "sphere_kernels_per_chunk",
               "sphere_g1_device_ms", "sphere_device_busy_share")},
           "psnr_vs_volume": float(psnr(img, sphere["headline"])),
           "miss_background_err": bg}
    log(f"  b. bench sphere row (phase 6's run), 800x800 in chunks of 4096: "
        f"{rec['rays_per_s']:.0f} rays/s ({rec['seconds']:.3f} s), "
        f"{rec['unresolved_rays']} unresolved rays, {rec['hits']} hits; G1 "
        f"launches per image {rec['g1_launches']}; PSNR against the "
        f"volumetric headline image {rec['psnr_vs_volume']:.2f} dB "
        f"(untrained weights); misses within {bg:.1e} of the background; "
        f"profile {json.dumps(rec['profile'])}")
    if not bool(torch.isfinite(img).all()):
        fail("16b: the sphere-traced 800x800 image is not finite")
    if bg > 1e-5:
        fail(f"16b: misses are {bg:.2e} off the background")
    if rec["e1_launches"] == 0 or rec["k1_launches"] != 0:
        fail(f"16b: the sphere row launched E1 {rec['e1_launches']}, K1 "
             f"{rec['k1_launches']} times")
    return rec


def surface_test_phase(torch, gather, scatter, system, state):
    """16c: the test protocol with ``eval_mode: sphere_trace`` on phase
    8's parameters made sharp as the bench's headline makes them
    (variance ``bench.VARIANCE``, its solid occupancy grid),
    ``SURFACE_VIEWS`` test view at ``SMALL_VIEW_WH`` in multi-emitter
    mode, then single-light mode (``check_protocol``'s bounds).  Returns
    its record."""
    from rise_sdf_tpu_torch import bench, measure

    variance = system.model.variance.variance
    soft = variance.detach().clone()
    sharp = {**state, "occ_binary": bench.solid_occupancy(system.model,
                                                          system.device)}
    torch.cuda.synchronize()
    gather.gather_rows.launches = 0
    scatter.scatter_add.launches = 0
    try:
        with torch.no_grad():
            variance.fill_(bench.VARIANCE)
        res = measure.test_protocol(system, sharp, views=SURFACE_VIEWS,
                                    log=log,
                                    model={"eval_mode": "sphere_trace"},
                                    relights=TEST_LIGHTS,
                                    img_wh=SMALL_VIEW_WH)
    finally:
        with torch.no_grad():
            variance.copy_(soft)
    g1, k1 = gather.gather_rows.launches, scatter.scatter_add.launches
    shutil.rmtree(os.path.join("exp", "test_protocol"), ignore_errors=True)
    log("  c. test protocol, eval_mode sphere_trace:")
    check_protocol(res)
    multi, single = res["multi"], res["single"]
    log(f"    G1 launches {g1}, K1 launches {k1}")
    if k1 != 0:
        fail(f"16c: K1 launched {k1} times")
    return {mode: {"s_per_view": run["s_per_view"],
                   "residual_rays": run["residual_rays"],
                   "g1_launches": run["g1_launches"],
                   "k1_launches": run["k1_launches"],
                   "metrics": run["metrics"]}
            for mode, run in (("multi", multi), ("single", single))}


def surface_phase(torch, gather, scatter, system, state, sphere):
    """Phase 16 (module docstring).  Returns its record."""
    t0 = time.perf_counter()
    rec = {"small": surface_small_phase(torch, gather, scatter),
           "bench": surface_render_check(torch, sphere),
           "test": surface_test_phase(torch, gather, scatter, system,
                                      state)}
    rec["seconds"] = time.perf_counter() - t0
    return rec


# phase 17: bit-reproducible training and the YAML configs.  (a) K2 on
# the recorded streams and two gather-backward shapes of the training
# scan; (b) the deterministic switch on NEUS_DET_STEPS NeuS steps (twice,
# and resumed at half way) and SPLIT_DET_STEPS stage-1 flagship steps
# (twice), against the default mode's runs; (c) ``launch --config``.
NEUS_DET_STEPS, SPLIT_DET_STEPS = 16, 8
# 17a's gather-backward shapes: the training scan's 4096 rays in a
# 1,048,576-slot buffer (``ops/volrend.py``, ``render_weight_from_alpha``)
SCAN_RAYS, SCAN_SLOTS = 4096, 1048576


def check_time_sorted(torch, scatter, sorted_ops, idx, vals, t, what,
                      period=1):
    """K2 twice on ``idx``, ``vals`` at the caller's ``period``: bit-equal
    to each other and to its plain version (the same fixed-point
    arithmetic in torch ops), its passes run one by one bit-equal to it
    too, and per entry within 1e-6 of the sum of the magnitudes
    landing there of a float64 sum; then median-of-10 times of K2, of
    each of its passes (``scatter_add_sorted_passes``), ``index_add_``
    and, for float32 rows, K1 at ``period``, and median-of-5 times (2
    calls each) of its plain version and of ``index_add_`` under
    ``torch.use_deterministic_algorithms(True)``, torch's own
    deterministic call for the same function."""
    from rise_sdf_tpu_torch.measure import median_ms

    a = sorted_ops.scatter_add_sorted(idx, vals, t, period)
    b = sorted_ops.scatter_add_sorted(idx, vals, t, period)
    plain = sorted_ops.scatter_add_sorted_plain(idx, vals, t)
    out, passes = sorted_ops.scatter_add_sorted_passes(idx, vals, t, period)
    for launch in passes.values():
        launch()
    ref = torch.zeros(plain.shape, dtype=torch.float64,
                      device=vals.device).index_add_(0, idx.long(),
                                                     vals.double())
    mag = torch.zeros(plain.shape, dtype=torch.float64,
                      device=vals.device).index_add_(0, idx.long(),
                                                     vals.double().abs())
    torch.cuda.synchronize()
    err = (a.double() - ref).abs()
    bad = int((err > 1e-6 * mag).sum())
    # the span of the values' binades, and the entries far below the
    # largest value, where one scale per call would keep too few bits
    nonzero = vals[torch.isfinite(vals) & (vals != 0)].double().abs()
    binades = torch.frexp(nonzero).exponent if nonzero.numel() else \
        torch.zeros(1, dtype=torch.int32)
    largest = float(nonzero.max()) if nonzero.numel() else 0.0
    far = int(((mag > 0) & (mag < largest * 2.0 ** -46)).sum())
    del nonzero
    same = bool(torch.equal(a, b))
    same_plain = bool(torch.equal(a, plain))
    same_passes = bool(torch.equal(a, out))
    rec = {"max_abs_err": float((a.double() - plain.double()).abs().max()),
           "max_abs_err_f64": float(err.max()), "bit_equal": same,
           "bit_equal_plain": same_plain, "bit_equal_passes": same_passes,
           "rows": int(idx.shape[0]), "width": int(vals.shape[1]),
           "dtype": str(vals.dtype).replace("torch.", ""),
           "table_rows": int(t), "period": period,
           "binades": [int(binades.min()), int(binades.max())],
           "entries_below_2^-46": far}
    del a, b, plain, out, ref, mag, err
    rec["ms"] = median_ms(lambda: sorted_ops.scatter_add_sorted(
        idx, vals, t, period))
    rec["pass_ms"] = {name: median_ms(fn) for name, fn in passes.items()}
    del passes
    rec["plain_ms"] = median_ms(
        lambda: sorted_ops.scatter_add_sorted_plain(idx, vals, t), reps=5,
        inner=2)

    def library():
        return torch.zeros((t, vals.shape[1]), dtype=vals.dtype,
                           device="cuda").index_add_(0, idx, vals)

    rec["library_ms"] = median_ms(library)
    with _Mode(torch, True):
        rec["library_det_ms"] = median_ms(library, reps=5, inner=2)
    rec["k1_ms"] = median_ms(lambda: scatter.scatter_add(
        idx, vals, t, period)) if vals.dtype == torch.float32 else None
    rec["bound_ms"] = max(
        (idx.shape[0] * 4 + vals.numel() * vals.element_size()
         + t * vals.shape[1] * vals.element_size()) / HBM_BYTES_PER_S,
        vals.numel() / F32_OPS_PER_S) * 1e3
    rec["bound_by"] = "bytes"
    k1 = f", K1 {rec['k1_ms']:.3f} ms" if rec["k1_ms"] is not None else ""
    log(f"  a. {what}: K2 {rec['ms']:.3f} ms (passes: "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["pass_ms"].items())
        + f"), plain {rec['plain_ms']:.3f} ms, index_add_ "
        f"{rec['library_ms']:.3f} ms, deterministic index_add_ "
        f"{rec['library_det_ms']:.3f} ms{k1}, bound {rec['bound_ms']:.4f} "
        f"ms (bytes; medians of 10, the plain and the deterministic "
        f"index_add_ of 5); bit-equal across launches {same}, to the plain "
        f"version {same_plain}, pass by pass {same_passes}; max |K2 - "
        f"float64 sum| {rec['max_abs_err_f64']:.3e}, entries over 1e-6 of "
        f"the magnitudes {bad}; values in binades {rec['binades']} (frexp's "
        f"exponents), {far} entries below 2^-46 of the largest value")
    if not (same and same_plain and same_passes) or bad:
        fail(f"17a: K2 on the {what}: bit-equal {same}, to its plain "
             f"version {same_plain}, pass by pass {same_passes}; {bad} "
             f"entries off a float64 sum")
    return rec


def sorted_stream_phase(torch, scatter, sorted_ops, host_streams):
    """17a: K2 on the training, probe and background streams (their
    cotangents, float32 F = 2, at the encodes' periods, as
    ``TableGradLookup`` passes them to K2 and K1), which phases 7, 8 and
    13 leave in ``host_streams`` as ``name -> (rows, vals, table rows)``
    on the host (phase 18a reads the first two again), and on the
    training scan's two gather backwards (float64 F = 1)."""
    recs = {}
    for name, period in (("train", 128), ("probe", 96),
                         ("background", 128)):
        if name not in host_streams:
            fail(f"17a: no {name} stream was recorded")
        rows, vals, t = host_streams[name]
        idx, vals = rows.reshape(-1).cuda(), vals.cuda()
        recs[name] = check_time_sorted(
            torch, scatter, sorted_ops, idx, vals, t,
            f"{name} stream ({idx.shape[0]} rows, P = {period})", period)
        del idx, vals
        torch.cuda.empty_cache()
    # the scan's per-ray starts (4096 rows into the buffer) and each
    # slot's ray (1,048,576 rows into the rays), the buffer ray-major
    rng = np.random.default_rng(17)
    counts = rng.integers(0, 480, SCAN_RAYS)  # ~94 % of the slots live
    used = int(counts.sum())
    if used > SCAN_SLOTS:
        fail(f"17a: {used} samples overflow the scan's buffer")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ray_of = np.full(SCAN_SLOTS, SCAN_RAYS)  # dead slots: the spare row
    ray_of[:used] = np.repeat(np.arange(SCAN_RAYS), counts)
    for name, idx, t in (("scan_starts", starts, SCAN_SLOTS),
                         ("scan_slots", ray_of, SCAN_RAYS + 1)):
        idx = torch.from_numpy(idx.astype(np.int32)).cuda()
        vals = torch.from_numpy(rng.standard_normal(
            (idx.shape[0], 1))).cuda()
        recs[name] = check_time_sorted(
            torch, scatter, sorted_ops, idx, vals, t,
            f"{name} gather backward ({idx.shape[0]} float64 rows into "
            f"{t})")
    return recs


class _Mode:
    """``torch.use_deterministic_algorithms(on)`` inside the block, the
    switch as it was after it."""

    def __init__(self, torch, on, warn_only=False):
        self.torch, self.on, self.warn_only = torch, on, warn_only

    def __enter__(self):
        t = self.torch
        self.was = (t.are_deterministic_algorithms_enabled(),
                    t.is_deterministic_algorithms_warn_only_enabled())
        t.use_deterministic_algorithms(self.on, warn_only=self.warn_only)

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(self.was[0],
                                                warn_only=self.was[1])


def _snapshot(torch, system, state):
    """The training state on the host: params and buffers, Adam's
    ``exp_avg``, ``exp_avg_sq`` and ``step``, the schedule's count,
    ``occs``, ``occ_binary`` and ``step``."""
    names = {id(p): n for n, p in system.model.state_dict(
        keep_vars=True).items()}
    snap = {f"param:{n}": p.detach().cpu().clone()
            for n, p in system.model.state_dict().items()}
    for p, st in system.optimizer.state.items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            snap[f"{k}:{names[id(p)]}"] = torch.as_tensor(st[k]).cpu().clone()
    snap["last_epoch"] = torch.tensor(system.scheduler.last_epoch)
    for k in ("occs", "occ_binary"):
        snap[k] = state[k].cpu().clone()
    snap["step"] = torch.tensor(int(state["step"]))
    return snap


def _differ(torch, a, b):
    """The entries of two snapshots that are not bit-equal, and the one
    of them with the largest difference relative to its largest value:
    ``(names, (name, max abs difference, relative))``."""
    bad = sorted(k for k in a if not torch.equal(a[k], b[k]))
    worst = ("", 0.0, 0.0)
    for k in bad:
        x, y = a[k].double(), b[k].double()
        diff = float((x - y).abs().max())
        rel = diff / max(float(x.abs().max()), 1e-300)
        if rel > worst[2]:
            worst = (k, diff, rel)
    return bad, worst


def _det_run(torch, scatter, gather, sorted_ops, system, state, steps,
             seed, det, probe=None):
    """``steps`` steps of ``fit`` from ``state`` in one mode, the counts
    zeroed just before and read just after.  Returns the state, steps/s
    over all but the first step and the K1, G1 and K2 launches and the
    run's seconds (``fit`` whole, its final checkpoint included).  A
    deterministic run given a ``probe`` list runs under ``warn_only``
    (the same algorithms) and adds to it the ops torch warns of
    (``_deterministic_warnings``)."""
    import warnings

    from rise_sdf_tpu_torch import measure

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, \
            _Mode(torch, det, warn_only=probe is not None):
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        scatter.scatter_add.launches = 0
        gather.gather_rows.launches = 0
        sorted_ops.scatter_add_sorted.launches = 0
        state, metrics, rate, _ = measure.train(
            system, steps, seed, state, profile_from=10 ** 9)
        counts = (scatter.scatter_add.launches, gather.gather_rows.launches,
                  sorted_ops.scatter_add_sorted.launches,
                  time.perf_counter() - t0)
    if probe is not None:
        probe += _deterministic_warnings(caught)
    if len(metrics) != steps or not all(np.isfinite(m["loss"])
                                        for m in metrics):
        fail(f"17b: a run without {steps} finite losses")
    if system.skipped_updates:
        fail(f"17b: {system.skipped_updates} skipped updates")
    k1, g1, k2, _ = counts
    if g1 < steps or (k2 < steps if det else k1 < steps) \
            or (k1 if det else k2):
        fail(f"17b: {'deterministic' if det else 'default'} run launched "
             f"K1 {k1}, G1 {g1}, K2 {k2} times in {steps} steps")
    return state, rate, counts


def _deterministic_warnings(caught):
    """The first lines of the caught warnings that name an op torch has
    no deterministic implementation for."""
    return [str(w.message).split("\n")[0] for w in caught
            if "deterministic" in str(w.message)]


def _warn_probe(torch, system, seed, step):
    """Two steps from ``step`` under ``warn_only``: the messages of the
    ops torch has no deterministic implementation for."""
    import warnings

    from rise_sdf_tpu_torch import measure

    state = system.init_state(seed)
    state["step"] = step
    with warnings.catch_warnings(record=True) as caught, \
            _Mode(torch, True, warn_only=True):
        warnings.simplefilter("always")
        measure.train(system, 2, seed, state, profile_from=10 ** 9)
    return _deterministic_warnings(caught)


def determinism_phase(torch, scatter, gather, sorted_ops, flagship, root):
    """17b (module docstring).  ``flagship`` is phase 8's system; NeuS
    gets a fresh ``neus_sphere_full``.  Returns its record."""
    from rise_sdf_tpu_torch import datasets, measure, presets, systems

    rec = {}
    cfg = presets.neus_sphere_full()
    seed = int(cfg["seed"])
    t0 = time.perf_counter()
    neus = systems.make(cfg["system"]["name"], cfg,
                        datasets.make(cfg["dataset"]["name"], cfg["dataset"]),
                        save_dir=os.path.join(root, "neus"), device="cuda")
    log(f"  b. neus_sphere_full built in {time.perf_counter() - t0:.1f} s")
    # the first deterministic run of each model is the warn_only probe
    # of its stage; the flagship's stage 0 gets two steps of its own
    t0 = time.perf_counter()
    probe = _warn_probe(torch, flagship, seed, 0)
    log(f"    under warn_only, two flagship steps at stage 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, system, steps, start in (
            ("neus", neus, NEUS_DET_STEPS, 0),
            ("flagship", flagship, SPLIT_DET_STEPS,
             measure.SPLIT_STAGE1_STEP)):
        runs, part = {}, {}
        for mode, det in (("default", False), ("det", True)):
            for i in range(2):
                state = system.init_state(seed)
                state["step"] = start
                state, rate, counts = _det_run(
                    torch, scatter, gather, sorted_ops, system, state,
                    steps, seed, det,
                    probe if det and i == 0 else None)
                runs[(mode, i)] = _snapshot(torch, system, state)
                part[f"{mode}{i}"] = {"steps_per_s": rate,
                                      "k1": counts[0], "g1": counts[1],
                                      "k2": counts[2], "s": counts[3]}
        if name == "neus":  # resumed at half way, deterministic
            half = steps // 2
            state = system.init_state(seed)
            state, _, _ = _det_run(torch, scatter, gather, sorted_ops,
                                   system, state, half, seed, True)
            path = system.save_checkpoint(state, os.path.join(
                root, "neus_half.ckpt.npz"))
            state = system.load_checkpoint(path)
            state, rate, counts = _det_run(torch, scatter, gather,
                                           sorted_ops, system, state,
                                           steps - half, seed, True)
            runs[("det", "resumed")] = _snapshot(torch, system, state)
            part["det_resumed"] = {"steps_per_s": rate, "k1": counts[0],
                                   "g1": counts[1], "k2": counts[2],
                                   "s": counts[3]}
        det_bad, _ = _differ(torch, runs[("det", 0)], runs[("det", 1)])
        res_bad = _differ(torch, runs[("det", 0)],
                          runs[("det", "resumed")])[0] \
            if ("det", "resumed") in runs else []
        def_bad, (worst, def_big, def_rel) = _differ(
            torch, runs[("default", 0)], runs[("default", 1)])
        part.update(entries=len(runs[("det", 0)]),
                    det_differing=len(det_bad),
                    resumed_differing=len(res_bad),
                    default_differing=len(def_bad),
                    default_worst=worst, default_max_abs_diff=def_big,
                    default_max_rel_diff=def_rel)
        rate = {m: part[f"{m}0"]["steps_per_s"] for m in ("default", "det")}
        log(f"    {name}, {steps} steps from step {start}, twice in each "
            f"mode{' and resumed at step ' + str(start + steps // 2) if name == 'neus' else ''}: "
            f"deterministic runs differ in {len(det_bad)} of "
            f"{part['entries']} state entries (params, Adam moments and "
            f"steps, schedule, occupancy grid, step)"
            f"{', the resumed run in ' + str(len(res_bad)) if name == 'neus' else ''}; "
            f"default runs in {len(def_bad)}, most in {worst} "
            f"({def_big:.3e}, {def_rel:.3e} of its largest value); steps/s "
            f"default {rate['default']:.3f}, "
            f"deterministic {rate['det']:.3f}; per run K1/G1/K2 launches "
            f"and seconds "
            + ", ".join(f"{k} {v['k1']}/{v['g1']}/{v['k2']} {v['s']:.1f} s"
                        for k, v in part.items() if isinstance(v, dict)))
        if det_bad or res_bad:
            fail(f"17b: {name} deterministic runs differ in "
                 f"{(det_bad + res_bad)[:8]}")
        rec[name] = part
    named = sorted(set(probe))
    log(f"    under warn_only, the NeuS run, the flagship's stage-0 steps "
        f"and its stage-1 run name {len(named)} ops without a "
        f"deterministic implementation{': ' if named else ''}"
        f"{'; '.join(named)}")
    if named:
        fail(f"17b: ops without a deterministic implementation: {named}")
    del neus
    shutil.rmtree(flagship.ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def config_phase(torch, scatter, gather, sorted_ops, scene_root, root):
    """17c: ``launch --config`` on ``configs/split-smoke.yaml`` (train 30
    steps across the stage flip, then test), and at full width for
    ``SCENE_STEPS`` steps on phase 12's scene on
    ``configs/split-mixed-occ-tensoir.yaml`` (its TensoIR layout) and
    ``configs/neus-blender.yaml`` (its Blender layout), each then tested
    and exported.  Returns each run's K1, G1 and K2 launches and
    seconds."""
    from rise_sdf_tpu_torch import launch, presets
    from rise_sdf_tpu_torch.utils import yamlio

    rec = {}

    def scene(layout):
        return ["dataset.scene=concave",
                f"dataset.root_dir={os.path.join(scene_root, layout)}",
                f"trainer.max_steps={SCENE_STEPS}"]

    for name, yaml_file, extra, preset in (
            ("split_smoke", "configs/split-smoke.yaml", [], None),
            ("tensoir", "configs/split-mixed-occ-tensoir.yaml",
             scene("tensoir"), presets.split_mixed_occ_tensoir),
            ("blender", "configs/neus-blender.yaml", scene("blender"),
             presets.neus_blender)):
        exp = os.path.join(root, name)
        torch.cuda.synchronize()
        scatter.scatter_add.launches = 0
        gather.gather_rows.launches = 0
        sorted_ops.scatter_add_sorted.launches = 0
        t0 = time.perf_counter()
        launch.main(["--config", yaml_file, "--train", "--exp_dir", exp,
                     *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"k1": scatter.scatter_add.launches,
                  "g1": gather.gather_rows.launches,
                  "k2": sorted_ops.scatter_add_sorted.launches,
                  "seconds": secs}
        trials = [os.path.join(dp, "config") for dp, dirs, _ in os.walk(exp)
                  if "config" in dirs]
        if len(trials) != 1 or sorted(os.listdir(trials[0])) != [
                "parsed.yaml", "raw.yaml"]:
            fail(f"17c: {name}: no config/parsed.yaml and raw.yaml: {trials}")
        parsed = yamlio.load_file(os.path.join(trials[0], "parsed.yaml"))
        parsed.pop("cmd_args"), parsed.pop("trial_dir")
        ckpts = [f for dp, _, fs in os.walk(exp) for f in fs
                 if f.endswith(".ckpt.npz")]
        log(f"  c. launch --config {yaml_file} {' '.join(extra)} --train: "
            f"{secs:.1f} s (train, test, export); K1/G1/K2 launches "
            f"{counts['k1']}/{counts['g1']}/{counts['k2']}; checkpoints "
            f"{ckpts}")
        if counts["k1"] < 1 or counts["g1"] < 1 or counts["k2"]:
            fail(f"17c: {name} launched {counts}")
        if preset is not None:
            # the preset with the same dotlist, but for the two entries
            # the yaml derives from trainer.max_steps
            want = launch.resolve(launch.apply_overrides(preset(), extra))
            warm = want["system"]["warmup_steps"]
            want["checkpoint"]["every_n_train_steps"] = SCENE_STEPS
            want["system"]["scheduler"]["schedulers"][1]["args"]["gamma"] = \
                0.1 ** (1.0 / (SCENE_STEPS - warm))
            same = parsed == want
            log(f"    parsed.yaml equals the preset {preset.__name__} "
                f"with the same dotlist (checkpoint.every_n_train_steps and "
                f"the ExponentialLR gamma recomputed from trainer.max_steps, "
                f"as the yaml's interpolations do): {same}")
            if not same:
                fail(f"17c: {name}'s parsed.yaml differs from the preset")
        rec[name] = counts
        gc.collect()
        torch.cuda.empty_cache()
    return rec


# phase 18: hash-table row sharding.  (b) starts from a one-process
# state SHARD_PRE_STEPS stage-1 steps in (at the fresh init the table
# takes no gradient).  Its tolerances: the first step's reduced
# gradients against a one-process step on the same batch, per tensor,
# SHARD_GRAD_TOL of its largest entry, or SHARD_SPREAD times the
# largest spread of SHARD_REFS one-process steps where that is larger:
# the card's atomics reorder every step's sums, and the geometry MLP's
# finite-difference gradients amplify that until two one-process steps
# differ by about their largest entry (the shards' features are summed
# in another order as well; PERF.md has the numbers); the
# partial validation view against the one-process render, absolute, as
# phase 11 holds its sharded view
SHARD_PRE_STEPS = 16
SHARD_REFS = 3
SHARD_GRAD_TOL = 1e-2
SHARD_SPREAD = 4.0
SHARD_RENDER_TOL = 2e-3
SHARDS = 2


def shard_rows(torch, idx, table_rows, m, tp=SHARDS):
    """Rows ``idx`` of a flattened ``[L * T, F]`` table (level l's row
    ``r`` at ``l T + r``) as shard ``m`` of ``tp`` holds them: level l's
    row ``l T / tp + r - m T / tp`` when that shard owns ``r``, else
    absent (-1), as ``HashGridEncoding._lookup`` builds them."""
    from rise_sdf_tpu_torch.measure import LOG2_T

    t = 1 << LOG2_T
    rows = t // tp
    level, r = idx // t, idx % t - m * rows
    return torch.where((r >= 0) & (r < rows), level * rows + r,
                       -1).to(torch.int32), table_rows // tp


def shard_stream_phase(torch, scatter, gather, sorted_ops, host_streams):
    """18a: K1, G1 and K2 on the training and probe streams cut as shards
    0 and 1 of ``SHARDS`` (module docstring).  Returns each kernel's
    records by stream and shard."""
    from rise_sdf_tpu_torch.measure import median_ms

    recs = {"k1": {}, "g1": {}, "k2": {}}
    for name, period in (("train", 128), ("probe", 96)):
        rows, vals_h, t = host_streams.pop(name)
        idx_full, vals = rows.reshape(-1).cuda(), vals_h.cuda()
        del rows, vals_h
        m_all = idx_full.shape[0]
        for m in range(SHARDS):
            idx, ts = shard_rows(torch, idx_full, t, m)
            keep = idx >= 0
            present = int(keep.sum())
            p_idx, p_vals = idx[keep], vals[keep]
            what = (f"{name} stream, shard {m} of {SHARDS} ({m_all} rows, "
                    f"{present} present, into {ts} x {F}, P = {period})")
            # K1 against the float64 reference of the present rows
            got = scatter.scatter_add(idx, vals, ts, period)
            torch.cuda.synchronize()
            k1 = {"max_abs_err": check_scatter(torch, got, p_idx, p_vals,
                                               ts, f"18a. K1 on the {what}")}
            del got
            k1["ms"] = median_ms(lambda: scatter.scatter_add(
                idx, vals, ts, period))
            k1["plain_ms"] = median_ms(lambda: scatter.scatter_add_plain(
                idx, vals, ts), reps=3, inner=1)
            # index_add_ of the present rows (no torch call drops an
            # index), timed without the filter
            k1["library_ms"] = median_ms(lambda: torch.zeros(
                (ts, F), device="cuda").index_add_(0, p_idx, p_vals))
            bound_bytes = m_all * 4 + present * F * 4 + ts * F * 4
            k1["bound_ms"] = max(bound_bytes / HBM_BYTES_PER_S,
                                 present * F / F32_OPS_PER_S) * 1e3
            k1["bound_by"] = "bytes"
            # G1 on a shard table, bit for bit
            table = torch.randn((ts, F), device="cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(18 + m))
            got = gather.gather_rows(table, idx)
            want = gather.gather_rows_plain(table, idx)
            torch.cuda.synchronize()
            equal = torch.equal(got.view(torch.int32),
                                want.view(torch.int32))
            del got, want
            distinct = int(torch.unique(p_idx).numel())
            g1 = {"max_abs_err": 0.0, "bit_equal": equal,
                  "ms": median_ms(lambda: gather.gather_rows(table, idx)),
                  "plain_ms": median_ms(lambda: gather.gather_rows_plain(
                      table, idx), reps=3, inner=1),
                  "library_ms": None,
                  "bound_ms": (m_all * 4 + distinct * F * 4 + m_all * F * 4)
                  / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
            del table
            # K2 bit for bit against its plain version
            a = sorted_ops.scatter_add_sorted(idx, vals, ts, period)
            plain = sorted_ops.scatter_add_sorted_plain(idx, vals, ts)
            torch.cuda.synchronize()
            same = bool(torch.equal(a, plain))
            k2 = {"max_abs_err": float((a - plain).abs().max()),
                  "bit_equal_plain": same,
                  "ms": median_ms(lambda: sorted_ops.scatter_add_sorted(
                      idx, vals, ts, period)),
                  "plain_ms": median_ms(
                      lambda: sorted_ops.scatter_add_sorted_plain(
                          idx, vals, ts), reps=3, inner=1),
                  "library_ms": None, "bound_ms": k1["bound_ms"],
                  "bound_by": "bytes"}
            del a, plain, p_idx, p_vals
            log(f"  a. {what}: K1 {k1['ms']:.3f} ms (plain "
                f"{k1['plain_ms']:.3f}, index_add_ of the present rows "
                f"{k1['library_ms']:.3f}); G1 {g1['ms']:.4f} ms (plain "
                f"{g1['plain_ms']:.4f}; {distinct} distinct rows), bit-equal "
                f"{equal}; K2 {k2['ms']:.3f} ms (plain {k2['plain_ms']:.3f}),"
                f" bit-equal to its plain version {same}; bound "
                f"{k1['bound_ms']:.4f} ms scatter, {g1['bound_ms']:.4f} ms "
                f"gather (bytes; medians of 10, the plain of 3)")
            if not (equal and same):
                fail(f"18a: on the {what}: G1 bit-equal {equal}, K2 "
                     f"bit-equal {same}")
            key = f"{name}_shard{m}"
            recs["k1"][key], recs["g1"][key], recs["k2"][key] = k1, g1, k2
            del idx, keep
        del idx_full, vals
        torch.cuda.empty_cache()
    return recs


def table_shard_phase(torch):
    """18b and 18c (module docstring).  Returns the window's record."""
    from rise_sdf_tpu_torch import bridge, datasets, measure, systems
    from rise_sdf_tpu_torch.parallel import dryrun
    from rise_sdf_tpu_torch.presets import split_mixed_occ_train_full

    world, backend = (SHARDS, "nccl") if torch.cuda.device_count() >= 2 \
        else (SHARDS, "gloo")
    out = os.path.join("exp", "chip_smoke_shards")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    cfg = split_mixed_occ_train_full()
    cfg["model"]["geometry"]["isosurface"]["resolution"] = \
        measure.EXPORT_RES
    seed = int(cfg["seed"])
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    one = systems.make(cfg["system"]["name"], cfg, dm,
                       save_dir=os.path.join(out, "one"), device="cuda")
    state = one.init_state(seed)
    state["step"] = measure.SPLIT_STAGE1_STEP
    state = one.fit(max_steps=measure.SPLIT_STAGE1_STEP + SHARD_PRE_STEPS,
                    seed=seed, state=state, log_every=0)
    ckpt = one.save_checkpoint(state, os.path.join(out, "pre.ckpt.npz"))
    start = int(state["step"])
    del state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = measure.table_shard_window(world, backend, out, ckpt=ckpt)
    window_s = time.perf_counter() - t0
    for r in ranks:
        k1s, g1s = zip(*r["launches_per_step"])
        log(f"  b. rank {r['rank']} ({backend}, {r['device']}, data="
            f"{r['mesh'][0]} x model={r['mesh'][1]}): {r['steps']} steps from "
            f"{start} in {r['fit_s']:.1f} s, {r['steps_per_s']:.3f} steps/s "
            f"after the first; K1/G1 launches per step {list(k1s)}/"
            f"{list(g1s)}; all-reduce per step {r['allreduce_mb_model']:.1f} "
            f"MB of features over the model group, "
            f"{r['allreduce_mb_world']:.1f} MB of replicated gradients over "
            f"the world; peak {r['peak_gib']:.2f} GiB; replicated params and "
            f"grid bit-equal {r['params_equal']}; {measure.VAL_CHUNKS} "
            f"validation chunks in {r['val_s']:.1f} s (K1/G1 "
            f"{r['val_launches']}); export in {r['export_s']:.1f} s, "
            f"{r['vertices']} vertices")
        if r["skipped"] or not np.all(np.isfinite(r["losses"])):
            fail(f"18b: rank {r['rank']}: losses {r['losses']}, skipped "
                 f"{r['skipped']}")
        if min(k1s) < 1 or min(g1s) < 1:
            fail(f"18b: rank {r['rank']}: a step without a K1 or G1 launch")
        if not r["params_equal"]:
            fail("18b: the ranks' replicated params differ")
    log(f"  b. the window with the ranks' start: {window_s:.1f} s")

    # one-process steps on the same batch from the same state
    steps = []
    for _ in range(SHARD_REFS):
        grads = {}
        state = one.load_checkpoint(ckpt)
        one.fit(max_steps=start + 1, seed=seed, state=state, log_every=1,
                on_log=lambda step, m: grads.update(
                    {k: p.grad.double().cpu() for k, p in
                     one.model.named_parameters()}))
        steps.append(grads)
    got = bridge.gather_params([
        {bridge.jax_path(k): v.numpy() for k, v in torch.load(
            os.path.join(out, f"grads{r}.pt")).items()}
        for r in range(SHARDS)])
    worst, rows = None, {}
    for k, a in steps[0].items():
        refs = [r[k].numpy() for r in steps]
        a = refs[0]
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(got[bridge.jax_path(k)] - a).max()) / scale
        spread = max(float(np.abs(x - y).max()) for i, x in enumerate(refs)
                     for y in refs[i + 1:]) / scale
        bound = max(SHARD_GRAD_TOL, SHARD_SPREAD * spread)
        rows[k] = [err, spread]
        if worst is None or err / bound > worst[1] / worst[3]:
            worst = (k, err, spread, bound)
    del steps, got, one
    torch.cuda.empty_cache()
    table = rows["geometry.encoding.encoding.table"]
    rounded = {k: [float(f"{x:.3e}") for x in v] for k, v in rows.items()}
    log(f"  b. step {start}'s reduced gradients (tables joined from the "
        f"shards) against a one-process step on the same batch, per tensor "
        f"|difference| / its largest entry, beside {SHARD_REFS} one-process "
        f"steps' largest spread: the table {table[0]:.3e} (spread {table[1]:.3e}); the "
        f"closest to its bound {worst[0]} {worst[1]:.3e} (spread "
        f"{worst[2]:.3e}, bound {worst[3]:.3e}); all {json.dumps(rounded)}")
    if worst[1] > worst[3]:
        fail(f"18b: the sharded step's gradient {worst[0]} is {worst[1]:.3e} "
             f"from the one-process step (bound {worst[3]:.3e})")

    # the tp=2 checkpoint in one process, the render and the export
    one = systems.make(cfg["system"]["name"], cfg, dm,
                       save_dir=os.path.join(out, "load"), device="cuda")
    one.init_state(seed)
    state = one.load_checkpoint(ranks[0]["ckpt"])
    loaded = bridge.to_jax_state(one.model, one.optimizer, one.scheduler)
    shards = [dict(np.load(os.path.join(out, f"state{r}.npz")))
              for r in range(SHARDS)]
    gathered = bridge.gather_params(shards)
    differ = [k for k in gathered
              if not np.array_equal(loaded[k], gathered[k])]
    log(f"  b. the tp=2 checkpoint loaded into one process: {len(loaded)} "
        f"entries, bit-equal to the ranks' gathered state "
        f"{not differ and sorted(loaded) == sorted(gathered)}")
    if differ or sorted(loaded) != sorted(gathered):
        fail(f"18b: the loaded checkpoint differs at {differ[:5]}")
    del loaded, shards, gathered
    split, one.view_rays = measure.val_chunks(one)
    with torch.no_grad():
        want = one.render_image(state, split, 0)
    sharded = np.load(os.path.join(out, "view.npz"))
    diffs = {k: float(np.abs(sharded[k] - want[k]).max()) for k in want
             if k != "ray_included"}
    log(f"  b. {measure.VAL_CHUNKS} chunks of validation view 0, tp=2 vs "
        f"one process, max |difference|: {json.dumps(diffs)}; rays dropped "
        f"{int((~sharded['ray_included']).sum())} / "
        f"{int((~want['ray_included']).sum())}")
    if max(diffs.values()) > SHARD_RENDER_TOL:
        fail("18b: the sharded validation chunks differ from the "
             "one-process render")
    t0 = time.perf_counter()
    mesh = one.export(state)
    export_s = time.perf_counter() - t0
    vertices = None if mesh is None else int(mesh["v_pos"].shape[0])
    log(f"  b. export at {measure.EXPORT_RES}^3: {ranks[0]['vertices']} "
        f"vertices at tp=2, {vertices} in one process ({export_s:.1f} s)")
    if vertices is None or vertices != ranks[0]["vertices"]:
        fail("18b: the sharded export's vertex count differs")
    del one, state, mesh
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dry = dryrun.dryrun_multichip(4, "cuda", "gloo")
    dry_s = time.perf_counter() - t0
    log(f"  c. dryrun_multichip(4) on four gloo ranks sharing the card: "
        f"data={dry['data']} x model={dry['model']}, loss "
        f"{dry['loss']:.5f}, {dry_s:.1f} s")
    if (dry["data"], dry["model"]) != (2, 2):
        fail(f"18c: dryrun_multichip(4) took data={dry['data']} x "
             f"model={dry['model']}")
    return {"backend": backend, "world": world,
            "mesh": ranks[0]["mesh"][:2], "steps": ranks[0]["steps"],
            "k1_per_rank_per_step": [[k for k, _ in r["launches_per_step"]]
                                     for r in ranks],
            "g1_per_rank_per_step": [[g for _, g in r["launches_per_step"]]
                                     for r in ranks],
            "steps_per_s": [r["steps_per_s"] for r in ranks],
            "allreduce_mb_model": ranks[0]["allreduce_mb_model"],
            "allreduce_mb_world": ranks[0]["allreduce_mb_world"],
            "peak_gib": [r["peak_gib"] for r in ranks],
            "grad_rel_err": rows, "render_max_abs": diffs,
            "vertices": vertices, "window_s": window_s,
            "dryrun": {"data": dry["data"], "model": dry["model"],
                       "loss": dry["loss"], "s": dry_s}}


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
    ap.add_argument("--test-views", type=int, default=1,
                    help="test views of the test protocol's multi-emitter "
                         "run")
    ap.add_argument("--resume-steps", type=int, default=32,
                    help="steps of the resumed run in the lifecycle phase")
    ap.add_argument("--save-streams", metavar="FILE",
                    help="save the recorded streams (torch.save) for "
                         "python -m rise_sdf_tpu_torch.kernel_ab")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # cuBLAS's workspace setting that torch's deterministic mode asks
    # for (phase 17b), before torch first calls cuBLAS
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    from rise_sdf_tpu_torch.ops import cuda_build, gather, scatter
    from rise_sdf_tpu_torch.ops import scatter_sorted as sorted_ops

    (scene_root, capture_root), (scene_job, capture_job) = start_writers()

    log("build K1, G1 and K2:")
    t0 = time.perf_counter()
    cuda_build.build_libraries(["scatter_add", "gather_rows",
                                "scatter_add_sorted"])
    scatter._lib()
    gather._lib()
    sorted_ops._lib()
    log(f"  built and loaded in {time.perf_counter() - t0:.1f} s")
    for name in ("scatter_add", "gather_rows", "scatter_add_sorted"):
        for line in cuda_build.build_logs.get(name, "").splitlines():
            log(f"  nvcc {name}: {line}")
    log("K1 vs float64 index_add_:")
    k1, s1 = kernel_phase(torch, scatter)
    log("G1 vs index_select:")
    g1, rows16 = gather_phase(torch, gather)
    log("small-input reference (card vs CPU):")
    small_reference_phase(torch)
    render_reference_phase(torch, gather)
    split_train_reference_phase(torch, gather, scatter)
    log("render slice: rise_sdf_tpu_torch.bench, split_mixed_occ_full, "
        "800x800:")
    g1["launches"], g1["render_stream"], streams, sphere, render16, e1 = \
        render_phase(torch, gather, scatter)
    rows16.update(render16)
    from rise_sdf_tpu_torch import bench, measure
    from rise_sdf_tpu_torch.presets import neus_sphere_full

    log(f"training slice: NeuS neus_sphere_full, {args.steps} steps + 1 "
        f"view:")
    (k1["launches"], k1["train_stream"], g1["train_stream"], per_step,
     train) = slice_phase(torch, scatter, args.steps, neus_sphere_full())
    if args.save_streams:
        torch.save({**streams, **train}, args.save_streams)
    # the recorded streams, kept on the host for phase 17a
    host_streams = {"train": (train["train_rows"], train["train_vals"],
                              train["train_table"].shape[0])}
    del streams, train
    log(f"flagship training: split-occ split_mixed_occ_train_full, "
        f"{args.split_steps} steps at stage 0 and at stage 1 + 1 view:")
    (k1["probe_stream"], g1["probe_stream"], split_step,
     (k1["flagship_launches"], g1["flagship_launches"]),
     (system, state)) = flagship_phase(torch, scatter, gather,
                                       args.split_steps, host_streams)
    log(f"test protocol: split_mixed_occ_test_full at step "
        f"{int(state['step'])}, {args.test_views} views x (learned, "
        f"{', '.join(TEST_LIGHTS)}) + view 0 in single-light mode:")
    (g1["test_launches"], g1["test_protocol"], lpips_pair, surface,
     gifs9) = test_protocol_phase(torch, gather, scatter, system, state,
                                  args.test_views)
    rows16["test_launches_per_view"] = \
        g1["test_protocol"]["multi_16_launches_per_view"]
    g1["rows16"] = rows16
    log(f"lifecycle: split_mixed_occ_test_full from step "
        f"{int(state['step'])}: save, load, {args.resume_steps} resumed "
        f"steps, export, the launch CLI:")
    t0 = time.perf_counter()
    life = lifecycle_phase(torch, gather, scatter, system, state,
                           args.resume_steps)
    log(f"  phase {time.perf_counter() - t0:.1f} s")
    log(f"data parallel: split_mixed_occ_train_full from step "
        f"{measure.SPLIT_STAGE1_STEP}, {measure.DDP_STEPS} steps over ranks "
        f"+ 1 sharded view:")
    t0 = time.perf_counter()
    ddp = ddp_phase(torch, scatter, gather)
    log(f"  phase {time.perf_counter() - t0:.1f} s")
    for key, rec in (("k1", k1), ("g1", g1)):
        rec["ddp"] = {"backend": ddp["backend"], "world": ddp["world"],
                      "steps": ddp["steps"],
                      "launches_per_rank": ddp[f"{key}_per_rank"]}
    log(f"a scene from disk: the concave scene at {SCENE_SIZE}x{SCENE_SIZE} "
        f"written and loaded in the TensoIR and Blender layouts; "
        f"split_mixed_occ_tensoir from step {measure.SPLIT_STAGE1_STEP}, "
        f"{SCENE_STEPS} steps + test on 1 view; neus_blender, {SCENE_STEPS} "
        f"steps:")
    t0 = time.perf_counter()
    # phase 12's scene is read again by phase 17c
    scene = scene_phase(torch, scatter, gather, scene_root, scene_job)
    log(f"  phase {time.perf_counter() - t0:.1f} s")
    for i, rec in enumerate((k1, g1)):
        rec["scene"] = {part: n[i] for part, n in scene.items()}
    log(f"a real capture: the concave scene on a floor at {CAPTURE_W}x"
        f"{CAPTURE_H}, {CAPTURE_VIEWS} views in COLMAP's layout; neus_colmap "
        f"at img_downscale {CAPTURE_DOWNSCALE}, {CAPTURE_STEPS} steps, one "
        f"step with the distortion loss, the test view and one predict "
        f"frame:")
    t0 = time.perf_counter()
    k1["capture"], g1["capture"], written = capture_phase(
        torch, scatter, gather, os.path.join(capture_root, "png"),
        host_streams, capture_job)
    log(f"  phase {time.perf_counter() - t0:.1f} s")
    log(f"what a capture or config names: the JPEG fixtures; the "
        f"capture as JPEG, neus_colmap {JPEG_STEPS} steps; "
        f"neus_sphere_full with AdamW, a chained schedule and variance "
        f"modulation, {MOD_STEPS} steps; LPIPS:")
    t0 = time.perf_counter()
    p14 = {"fixtures": jpeg_fixture_phase(),
           "jpeg_capture": jpeg_capture_phase(
               torch, scatter, gather, os.path.join(capture_root, "jpeg"),
               written)}
    del written
    shutil.rmtree(capture_root, ignore_errors=True)
    p14["config_surface"] = config_surface_phase(torch, scatter, gather)
    p14["lpips"] = lpips_phase(torch, scatter, gather, system, state,
                               lpips_pair)
    p14["seconds"] = time.perf_counter() - t0
    log(f"  phase {p14['seconds']:.1f} s")
    log(f"  phase 14: {json.dumps(p14)}")
    for key, rec in (("k1", k1), ("g1", g1)):
        rec["phase14"] = {part: p14[part][key] for part in (
            "jpeg_capture", "config_surface", "lpips")}
    log(f"the appearance library: neus_sphere_color_full {COLOR_STEPS} "
        f"steps + 1 view; volume-pbr + brdf-ggx on phase 9's view 0; the "
        f"learned light's importance sampling; the warp samplers and four "
        f"ops at 800x800; the test GIFs of phases 9 and 14d:")
    t0 = time.perf_counter()
    p15 = appearance_phase(torch, scatter, gather, system, state, surface,
                           {"phase9": gifs9,
                            "phase14d": p14["lpips"].pop("gifs")})
    p15["seconds"] = time.perf_counter() - t0
    log(f"  phase {p15['seconds']:.1f} s")
    log(f"  phase 15: {json.dumps(p15)}")
    log(f"the sphere-traced eval: tiny forward_surface / "
        f"forward_surface_multi card vs CPU; the bench's sphere row at "
        f"800x800; split_mixed_occ_test_full with eval_mode sphere_trace at "
        f"step {int(state['step'])} (variance {bench.VARIANCE}, solid "
        f"occupancy), {SURFACE_VIEWS} view in both modes:")
    p16 = surface_phase(torch, gather, scatter, system, state, sphere)
    del state, lpips_pair, surface, sphere
    torch.cuda.empty_cache()
    log(f"  phase {p16['seconds']:.1f} s")
    log(f"  phase 16: {json.dumps(p16)}")
    log(f"bit-reproducible training and the YAML configs: K2 on the "
        f"recorded streams; under torch.use_deterministic_algorithms, "
        f"neus_sphere_full {NEUS_DET_STEPS} steps twice and resumed, the "
        f"flagship {SPLIT_DET_STEPS} stage-1 steps twice, each against the "
        f"default mode; launch --config on split-smoke.yaml, "
        f"split-mixed-occ-tensoir.yaml and neus-blender.yaml:")
    t0 = time.perf_counter()
    p17_root = tempfile.mkdtemp(prefix="chip_smoke_p17_")
    atexit.register(shutil.rmtree, p17_root, True)
    p17 = {"streams": sorted_stream_phase(torch, scatter, sorted_ops,
                                          host_streams),
           "determinism": determinism_phase(torch, scatter, gather,
                                            sorted_ops, system, p17_root)}
    del system
    torch.cuda.empty_cache()
    p17["config"] = config_phase(torch, scatter, gather, sorted_ops,
                                 scene_root, p17_root)
    p17["seconds"] = time.perf_counter() - t0
    log(f"  phase {p17['seconds']:.1f} s")
    log(f"  phase 17: {json.dumps(p17)}")
    log(f"hash-table row sharding: K1, G1 and K2 on the training and probe "
        f"streams as shards of {SHARDS}; split_mixed_occ_train_full with "
        f"table_shards {SHARDS} on {SHARDS} ranks from step "
        f"{measure.SPLIT_STAGE1_STEP}, {measure.TABLE_SHARD_STEPS} steps, "
        f"{measure.VAL_CHUNKS} validation chunks and the export against one "
        f"process; dryrun_multichip(4):")
    t0 = time.perf_counter()
    p18 = {"streams": shard_stream_phase(torch, scatter, gather, sorted_ops,
                                         host_streams)}
    p18["window"] = table_shard_phase(torch)
    p18["seconds"] = time.perf_counter() - t0
    log(f"  phase {p18['seconds']:.1f} s")
    log(f"  phase 18: {json.dumps(p18['window'])}")
    k2 = dict(p17["streams"]["train"])
    k2["launches"] = p17["determinism"]["neus"]["det0"]["k2"]
    k2["streams"] = p17["streams"]
    k2["launches_per_run"] = {
        name: {run: v["k2"] for run, v in part.items()
               if isinstance(v, dict)}
        for name, part in p17["determinism"].items()}
    k1["phase17"] = {name: {run: v["k1"] for run, v in part.items()
                            if isinstance(v, dict)}
                     for name, part in p17["determinism"].items()}
    k1["phase17"]["config"] = {k: v["k1"] for k, v in p17["config"].items()}
    g1["phase17"] = {k: v["g1"] for k, v in p17["config"].items()}
    test16 = p16["test"]
    k1["phase16"] = {"small": p16["small"][1],
                     "sphere_row": p16["bench"]["k1_launches"],
                     "test_multi": test16["multi"]["k1_launches"],
                     "test_single": test16["single"]["k1_launches"]}
    for key, rec in (("k1", k1), ("g1", g1), ("k2", k2)):
        rec["phase18"] = p18["streams"][key]
    for key, rec in (("k1", k1), ("g1", g1)):
        rec["phase18"]["launches_per_rank_per_step"] = \
            p18["window"][f"{key}_per_rank_per_step"]
    g1["phase16"] = {"small": p16["small"][0],
                     "sphere_row": p16["bench"]["g1_launches"],
                     "test_multi": test16["multi"]["g1_launches"],
                     "test_single": test16["single"]["g1_launches"]}
    color = p15["color"]
    k1["phase15"] = {"color_train": color["k1"],
                     "color_validate": color["validate_k1"]}
    g1["phase15"] = {"color_train": color["g1"],
                     "color_validate": color["validate_g1"],
                     "pbr": p15["pbr"]["g1"]}
    k1["resume_launches"] = life["k1"]
    g1["resume_launches"] = life["g1"]
    g1["export_launches"] = life["g1_export"]
    e1["export_launches"] = life["e1_export"]
    e1["phase15"] = {"color_validate": color["validate_e1"]}
    e1["phase16"] = {"sphere_row": p16["bench"]["e1_launches"]}
    k1["resume_launches_per_step"] = life["k1_per_step"]
    g1["resume_launches_per_step"] = life["g1_per_step"]
    s1["launches"] = k1["launches"]
    for key, rec in (("k1", k1), ("g1", g1)):
        for name, prof in (("per_step", per_step),
                           ("flagship_per_step", split_step)):
            if prof:
                rec[name] = {"device_ms": prof[f"{key}_ms"],
                             "launches": prof[f"{key}_launches"]}

    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    log(card)
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = ("train_stream", "render_stream", "per_step", "probe_stream",
             "flagship_per_step", "flagship_launches", "test_launches",
             "test_protocol", "resume_launches", "resume_launches_per_step",
             "export_launches", "ddp", "scene", "capture", "phase14",
             "phase15", "phase16", "phase17", "phase18", "rows16")
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
        {"name": "scatter_add_sorted (K2)", "route": "cuda",
         "source": SRC_K2, "replaces": REPLACES_K2,
         **{k: k2[k] for k in keys},
         **{k: k2[k] for k in ("streams", "launches_per_run", "pass_ms",
                                "library_det_ms", "k1_ms", "phase18")}},
        {"name": "eval encode (E1f/E1b)", "route": "cuda", "source": SRC_E1,
         "replaces": REPLACES_E1, **{k: e1[k] for k in keys},
         **{k: e1[k] for k in e1 if k not in keys}},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
