"""Eval throughput of the flagship render: rays/s for one 800x800 image.

    python -m rise_sdf_tpu_torch.bench [--device cuda|cpu]
                                       [--preset full|tiny]
                                       [--profile-chunks N]

The protocol is the headline of the JAX package's ``bench.py``: the
``split_mixed_occ_full`` model (``configs/split-mixed-occ-tensoir.yaml``)
with untrained parameters drawn from the preset's seed, except the variance,
set to 0.67 (inv_s ~ 812, a converged surface); a solid occupancy grid
(cells within 0.5 + 2 cells of the centre); ``step =
split_sum_kick_in_step + 1`` (stage 1, 14 of 16 hash levels open); the
visibility prefilter with banded marching at
``eval_banded_samples_per_ray`` samples per ray into a buffer of
``chunk * 8 + eval_band_reserve`` slots; the ``eval_sdf_bake: full``
table at 128 cells; the golden ray interleave; serial chunks of
``ray_chunk`` rays (157 for 800x800), the last one shorter.

One warm-up pass (mips, bake, first chunk) builds the kernels.  The
timed image then builds the mips, bakes the SDF and renders every chunk,
as a real eval of one checkpoint does; rays/s is the image's rays over
that time.  The script prints one JSON line: rays/s, dropped rays, the
mip-build, bake and render seconds, the kernels' launches in the timed
image (``g1_16_launches``: those of G1's 16-byte path, the baked-SDF
sample; ``e1_launches``: E1's features kernel, the eval encode), peak
device memory and the image's largest opacity (above 1 by
the float32 error of the transmittance scan); with ``--profile-chunks
N``, the device time of ``N`` chunks by kernel under ``torch.profiler``,
G1's share of it and its 16-byte path's ms and launches, and the same
(``sphere_profile_*``) for ``N // 4`` chunks of the sphere row.

After the headline, the ``sphere`` row of the JAX package's bench: the
same model, sharp variance and solid occupancy rendered by sphere tracing
(``forward_surface`` at stage 1, no bake), in serial chunks of 4096 rays
in row-major order, the mips built inside the timed image;
``sphere_trace_rays_per_sec`` and ``sphere_trace_unresolved_rays`` (the
rays the trace or its guard leaves to a volumetric re-render, which the
row does not run) join the JSON line, with the row's G1, E1 and K1
launches.  The JAX bench pads its last chunk with zero rays; here it is
shorter.

``--preset tiny`` renders the tiny split config at 16x16 (CPU smoke).
The default device is the card; without CUDA it raises unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import models, presets
from .datasets.synthetic import look_at
from .ops import prefilter
from .ops.gather import gather_rows
from .ops.hashgrid_eval import encode_features
from .ops.scatter import scatter_add
from .utils.misc import interleave_order
from .utils.rays import get_ray_directions, get_rays

VARIANCE = 0.67  # exp(10 * 0.67) ~ 812: the end of a production run
SIZES = {"full": 800, "tiny": 16}  # image side per preset


def tiny_bench_config():
    """``tiny_split_config`` with the flagship's eval options, at the
    tiny widths: prefilter, exact-K bands of 8 with a reserve, the full
    bake, both compactions and the golden interleave, chunks of 256."""
    cfg = presets.tiny_split_config()
    cfg["seed"] = 0
    cfg["model"].update({
        "num_samples_per_ray": 256, "visibility_prefilter": True,
        "prefilter_stride": 4, "prefilter_margin_intervals": 1.0,
        "eval_sdf_bake": "full", "eval_sdf_bake_cells": 32,
        "eval_banded_samples_per_ray": 8, "eval_band_reserve": 256,
        "eval_visibility_frac": 0.5, "secondary_sample_capacity_frac": 0.375,
        "eval_ray_interleave": "golden", "ray_chunk": 256})
    return cfg


def image_rays(size: int, device) -> torch.Tensor:
    """[size^2, 6] rays of the bench camera: (0, -4, 0) looking at the
    origin, focal 0.5 * size / tan(0.175), unit directions."""
    focal = 0.5 * size / np.tan(0.5 * 0.35)
    dirs = get_ray_directions(size, size, focal, focal, size // 2, size // 2)
    c2w = look_at(np.array([0.0, -4.0, 0.0]))
    rays_o, rays_d = get_rays(torch.from_numpy(dirs.astype(np.float32)),
                              torch.from_numpy(c2w))
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    return torch.cat([rays_o, rays_d], -1).to(device)


def solid_occupancy(model, device) -> torch.Tensor:
    """[res^3] bool: cells whose centre lies within 0.5 + 2 cells of the
    origin (the solid interior a converged grid keeps occupied)."""
    res = model.grid_resolution
    g = (np.arange(res) + 0.5) / res * 2 * model.radius - model.radius
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    cell = 2 * model.radius / res
    return torch.from_numpy((r < 0.5 + 2.0 * cell).reshape(-1)).to(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_times(prof):
    """{kernel name: (device ms, launches)} from a ``torch.profiler`` run."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, count = out.get(e.key, (0.0, 0))
        out[e.key] = (ms + e.self_device_time_total / 1e3, count + e.count)
    return out


def run(preset: str = "full", device="cuda", profile_chunks: int = 0,
        log=None) -> dict:
    """Render one ``SIZES[preset]``-square image with the bench
    protocol; returns the results (``image`` [size, size, 3] and
    ``included`` [size^2] stay on the device, the rest are numbers)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu "
                               "to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    log = log or (lambda msg: None)
    cfg = presets.split_mixed_occ_full() if preset == "full" \
        else tiny_bench_config()
    mcfg, size = cfg["model"], SIZES[preset]
    res = {"preset": preset, "size": size, "device": str(device)}

    t0 = time.perf_counter()
    prefilter.build_specular_filter_bank(
        int(mcfg["light"]["envlight_config"]["base_res"]))
    res["prefilter_bank_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = models.make(mcfg["name"], mcfg)
    res["model_build_s"] = time.perf_counter() - t0
    model.reset_parameters(torch.Generator().manual_seed(int(cfg["seed"])))
    with torch.no_grad():
        model.variance.variance.fill_(VARIANCE)
    model.to(device).requires_grad_(False)
    log(f"model built in {res['model_build_s']:.1f} s (prefilter bank "
        f"{res['prefilter_bank_s']:.1f} s)")

    occ = solid_occupancy(model, device)
    rays = rowmajor = image_rays(size, device)
    n, chunk = rays.shape[0], int(mcfg["ray_chunk"])
    order, inv = interleave_order(n, chunk,
                                  mcfg.get("eval_ray_interleave", False))
    if order is not None:
        rays = rays[torch.from_numpy(order).to(device)]
    step = int(mcfg["split_sum_kick_in_step"]) + 1
    kw = dict(occ_binary=occ, step=step,
              background_color=torch.ones(3, device=device),
              **model.eval_options(step, chunk))
    res.update(rays=n, chunk=chunk, n_chunks=-(-n // chunk),
               capacity=kw["capacity"], step=step, stage=kw["stage"])

    # warm-up: builds the kernels, touches every code path once
    t0 = time.perf_counter()
    mips = model.emitter.build_mips()
    bake = model.bake_eval_sdf(step)
    model(rays[:chunk], mips=mips, bake=bake, **kw)
    _sync(device)
    res["warmup_s"] = time.perf_counter() - t0
    log(f"warm-up (kernel builds, one chunk) {res['warmup_s']:.1f} s")

    # the timed image
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    g1, k1 = gather_rows.launches, scatter_add.launches
    g16, e1 = gather_rows.launches16, encode_features.launches
    rgb = torch.empty((n, 3), device=device)
    included = torch.empty((n,), dtype=torch.bool, device=device)
    # opacity above 1 measures the float32 error of the transmittance
    # scan (one cumsum over the whole chunk's buffer)
    opacity_max = torch.zeros((), device=device)
    t_start = time.perf_counter()
    mips = model.emitter.build_mips()
    _sync(device)
    t_mips = time.perf_counter()
    bake = model.bake_eval_sdf(step)
    _sync(device)
    t_bake = time.perf_counter()
    for s in range(0, n, chunk):
        out = model(rays[s:s + chunk], mips=mips, bake=bake, **kw)
        rgb[s:s + chunk] = out["comp_rgb_full"]
        included[s:s + chunk] = out["ray_included"]
        opacity_max = torch.maximum(opacity_max, out["opacity"].max())
    _sync(device)
    t_end = time.perf_counter()
    res.update(
        mip_build_s=t_mips - t_start, bake_s=t_bake - t_mips,
        render_s=t_end - t_bake, image_s=t_end - t_start,
        rays_per_s=n / (t_end - t_start),
        dropped_rays=int((~included).sum()),
        opacity_max=float(opacity_max),
        g1_launches=gather_rows.launches - g1,
        g1_16_launches=gather_rows.launches16 - g16,
        e1_launches=encode_features.launches - e1,
        k1_launches=scatter_add.launches - k1)
    if device.type == "cuda":
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) \
            / 2 ** 30
    # the JAX package's bench pads its last chunk with zero rays and
    # counts their drops too: the same count, for its records
    last = (n - 1) // chunk * chunk
    if n - last < chunk:
        part = torch.cat([rays[last:], rays.new_zeros((chunk - n + last, 6))])
        out = model(part, mips=mips, bake=bake, **kw)
        res["dropped_rays_zero_padded"] = int((~included[:last]).sum()) \
            + int((~out["ray_included"]).sum())
    if inv is not None:
        back = torch.from_numpy(inv).to(device)
        rgb, included = rgb[back], included[back]
    res["image"] = rgb.reshape(size, size, 3)
    res["included"] = included
    res["finite"] = bool(torch.isfinite(rgb).all())
    log(f"image: {res['rays_per_s']:.0f} rays/s, {res['dropped_rays']} "
        f"dropped, mips {res['mip_build_s']:.3f} s, bake "
        f"{res['bake_s']:.3f} s, render {res['render_s']:.3f} s")

    res.update(sphere_row(model, rowmajor, occ, step, log))
    if profile_chunks > 0 and device.type == "cuda":
        res.update(profile(
            lambda s: model(rays[s:s + chunk], mips=mips, bake=bake, **kw),
            device, chunk, profile_chunks))
        # the sphere row's chunks from the middle of the image
        mid = rowmajor.shape[0] // 2 - SPHERE_CHUNK * profile_chunks // 4
        sphere = profile(
            lambda s: model.forward_surface(
                rowmajor[mid + s:mid + s + SPHERE_CHUNK], mips=mips,
                occ_binary=occ, step=step, stage=1,
                background_color=torch.ones(3, device=device)),
            device, SPHERE_CHUNK, max(profile_chunks // 4, 1))
        res.update({f"sphere_{k}": v for k, v in sphere.items()})
    return res


SPHERE_CHUNK = 4096  # the JAX bench's continuity chunk


def sphere_row(model, rays, occ, step, log) -> dict:
    """The sphere-traced image of ``rays`` (row-major): one warm-up
    chunk, then the mips and every chunk timed.  Returns rays/s, the
    unresolved rays, the seconds, G1's, E1's and K1's launches in the timed
    image and (on the device) the image ``sphere_image`` [N, 3] and its
    opacity ``sphere_opacity`` [N]."""
    device, n = rays.device, rays.shape[0]
    kw = dict(occ_binary=occ, step=step, stage=1,
              background_color=torch.ones(3, device=device))
    model.forward_surface(rays[:SPHERE_CHUNK],
                          mips=model.emitter.build_mips(), **kw)
    _sync(device)
    g1, k1 = gather_rows.launches, scatter_add.launches
    e1 = encode_features.launches
    rgb = torch.empty((n, 3), device=device)
    opacity = torch.empty((n,), device=device)
    unresolved = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    mips = model.emitter.build_mips()
    for s in range(0, n, SPHERE_CHUNK):
        out = model.forward_surface(rays[s:s + SPHERE_CHUNK], mips=mips,
                                    **kw)
        rgb[s:s + SPHERE_CHUNK] = out["comp_rgb_full"]
        opacity[s:s + SPHERE_CHUNK] = out["opacity"][:, 0]
        unresolved += (~out["ray_included"]).sum()
    _sync(device)
    dt = time.perf_counter() - t0
    res = {"sphere_trace_rays_per_sec": n / dt,
           "sphere_trace_unresolved_rays": int(unresolved),
           "sphere_trace_s": dt,
           "sphere_trace_g1_launches": gather_rows.launches - g1,
           "sphere_trace_e1_launches": encode_features.launches - e1,
           "sphere_trace_k1_launches": scatter_add.launches - k1,
           "sphere_image": rgb, "sphere_opacity": opacity}
    log(f"sphere trace: {res['sphere_trace_rays_per_sec']:.0f} rays/s, "
        f"{res['sphere_trace_unresolved_rays']} unresolved")
    return res


def profile(render, device, chunk, n_chunks) -> dict:
    """Device time of ``n_chunks`` chunks (``render(s)`` renders the one
    at ray ``s``) by kernel (``torch.profiler``) beside their wall time;
    G1's share of the device time, and its 16-byte path's
    (``gather_rows16_kernel``) ms and launches."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    _sync(device)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(0, n_chunks * chunk, chunk):
            render(s)
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    times = _kernel_times(prof)
    total = sum(t for t, _ in times.values())
    g1 = sum(t for k, (t, _) in times.items() if "gather_rows" in k)
    g16 = [v for k, v in times.items() if "gather_rows16" in k]
    top = sorted(times.items(), key=lambda kv: -kv[1][0])[:12]
    return {"profile_chunks": n_chunks, "profile_wall_ms": wall_ms,
            "profile_device_ms": total,
            "kernels_per_chunk": sum(c for _, c in times.values()) / n_chunks,
            "g1_device_ms": g1,
            "g1_16_device_ms": sum(t for t, _ in g16),
            "g1_16_profile_launches": sum(c for _, c in g16),
            "g1_share": g1 / total if total > 0 else None,
            "device_busy_share": total / wall_ms if wall_ms > 0 else None,
            "top_kernels_ms": [[k[:80], t, c] for k, (t, c) in top]}


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", choices=tuple(SIZES), default="full")
    ap.add_argument("--profile-chunks", type=int, default=0)
    args = ap.parse_args(argv)
    res = run(args.preset, args.device, args.profile_chunks,
              log=lambda msg: print(msg, file=sys.stderr, flush=True))
    if torch.device(args.device).type == "cuda":
        res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps({k: v for k, v in res.items() if k not in (
        "image", "included", "sphere_image", "sphere_opacity")}))
    return res


if __name__ == "__main__":
    main()
