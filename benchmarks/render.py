"""Eval traffic: back-to-back square images of the flagship under the
headline protocol of the program's ``bench``: untrained parameters from
the seed with the variance set to ``variance``, a solid occupancy grid
(cells within 0.5 + 2 cells of the centre), the step
``split_sum_kick_in_step + 1`` (stage 1), the model's eval options at
the traffic's ``ray_chunk``, the golden ray interleave, serial chunks
(the last one shorter).  Each image builds the mips and bakes the SDF,
as an eval of one checkpoint does.

Set-up renders one whole image (every shape the window uses).  The
window renders chunks until ``seconds`` have passed and ends
synchronised: rays/s is the rays of the chunks rendered over the
window's wall time, each image's mips and bake included; ``failed``
counts the rays a chunk dropped (``ray_included`` false).  The chunks
that ``correct`` compares are drawn from the seed; their first render
in the window is kept, and once the program is freed the reference
renders the same rays from the same weights, with its own mips and bake.

With ``trace``, the window times each image's mips and bake
synchronised and counts each chunk's live and visible samples; after it
one whole image is profiled for the device's busy share and the
breakdown, and the next with the host's operations and the kernels'
launches recorded.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from . import common
from .yardstick import compare, flops, launches


def image_rays(size: int, eye, fov: float, device) -> torch.Tensor:
    """[size^2, 6] unit rays of a camera at ``eye`` looking at the
    origin with the field of view ``fov``."""
    from .reference.datasets.synthetic import look_at
    from .reference.utils.rays import get_ray_directions, get_rays

    focal = 0.5 * size / np.tan(0.5 * fov)
    dirs = get_ray_directions(size, size, focal, focal, size // 2, size // 2)
    c2w = look_at(np.asarray(eye, dtype=np.float64))
    rays_o, rays_d = get_rays(torch.from_numpy(dirs.astype(np.float32)),
                              torch.from_numpy(c2w))
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    return torch.cat([rays_o, rays_d], -1).to(device)


def solid_occupancy(res: int, radius: float, device) -> torch.Tensor:
    """[res^3] bool: cells whose centre lies within 0.5 + 2 cells of the
    origin (the solid interior a converged grid keeps occupied)."""
    g = (np.arange(res) + 0.5) / res * 2 * radius - radius
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    cell = 2 * radius / res
    return torch.from_numpy((r < 0.5 + 2.0 * cell).reshape(-1)).to(device)


def model_config(cell) -> dict:
    mcfg = dict(cell.config["run"]["model"])
    mcfg.update(cell.traffic.get("model", {}))
    return mcfg


class Renderer:
    """One model with the protocol's inputs, rendering chunk by chunk."""

    def __init__(self, model, cell, device):
        tr = cell.traffic
        mcfg = model_config(cell)
        with torch.no_grad():
            model.variance.variance.fill_(float(tr["variance"]))
        model.requires_grad_(False)
        self.model, self.device = model, device
        self.occ = solid_occupancy(model.grid_resolution, model.radius,
                                   device)
        rays = image_rays(int(tr["image_wh"]), tr["eye"], float(tr["fov"]),
                          device)
        from .reference.utils.misc import interleave_order

        self.chunk = int(mcfg["ray_chunk"])
        order, _ = interleave_order(rays.shape[0], self.chunk,
                                    mcfg.get("eval_ray_interleave", False))
        if order is not None:
            rays = rays[torch.from_numpy(order).to(device)]
        self.rays = rays
        self.starts = list(range(0, rays.shape[0], self.chunk))
        self.step = int(mcfg["split_sum_kick_in_step"]) + 1
        self.kw = dict(occ_binary=self.occ, step=self.step,
                       background_color=torch.ones(3, device=device),
                       **model.eval_options(self.step, self.chunk))
        self.mips = self.bake = None

    def prepare_image(self):
        self.mips = self.model.emitter.build_mips()
        self.bake = self.model.bake_eval_sdf(self.step)

    def chunk_out(self, i: int) -> Dict:
        s = self.starts[i]
        return self.model(self.rays[s:s + self.chunk], mips=self.mips,
                          bake=self.bake, **self.kw)


def sampled_chunks(seed: int, n_chunks: int, k: int):
    rng = np.random.default_rng(common.step_seed(seed, 7))
    return sorted(int(i) for i in rng.choice(n_chunks, size=min(k, n_chunks),
                                             replace=False))


def keep(out) -> Dict:
    return {"rgb": out["comp_rgb_full"].float().cpu().numpy(),
            "included": out["ray_included"].cpu().numpy().astype(bool)}


def reference_answers(cell, seed, device, chunks, tf32=False) -> Dict:
    from .reference import models

    mcfg = model_config(cell)
    model = common.reference_weights(models, mcfg, seed, device)
    r = Renderer(model, cell, device)
    if torch.device(device).type == "cuda":
        common.tf32(tf32)
    with torch.no_grad():
        r.prepare_image()
        out = {i: keep(r.chunk_out(i)) for i in chunks}
    common.tf32(False)
    return out


def build(cell, seed, device, log=lambda msg: None) -> Renderer:
    import rise_sdf_tpu_torch.models as models

    from .reference import models as ref_models

    mcfg = model_config(cell)
    lap = common.Laps(log)
    ref = common.reference_weights(ref_models, mcfg, seed, device)
    weights = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    dims = flops.mlp_dims(ref)
    del ref
    lap("weights")
    model = models.make(mcfg["name"], mcfg).to(device)
    model.load_state_dict(weights)
    del weights
    r = Renderer(model, cell, device)
    r.dims = dims
    lap("program model")
    return r


def _answers(prog: Dict, ref: Dict) -> Dict:
    cat = lambda side, k: np.concatenate([side[i][k] for i in sorted(prog)])
    return compare.render_numbers(
        {"rgb": cat(prog, "rgb"), "included": cat(prog, "included")},
        {"rgb": cat(ref, "rgb"), "included": cat(ref, "included")})


def run(cell, seed: int, seconds: float, traced: bool, device, clock,
        log) -> Dict:
    tr = cell.traffic
    log(f"process start to the cell's set-up {clock.since():.2f} s")
    r = build(cell, seed, device, log)
    lap = common.Laps(log)
    with torch.no_grad():
        r.prepare_image()
        for i in range(len(r.starts)):
            r.chunk_out(i)
    common.sync(device)
    lap("warm image")
    setup_s = clock.since()
    log(f"set-up {setup_s:.1f} s; {len(r.starts)} chunks of {r.chunk} "
        "rays an image")

    # the seed's sample, and the window's first chunk, which every
    # window renders
    wanted = set(sampled_chunks(seed, len(r.starts),
                                int(tr["compared_chunks"]))) | {0}
    kept, spans, stats = {}, [], []
    dropped = torch.zeros((), dtype=torch.int64, device=device)
    n_rays, i = 0, 0
    cap = int(r.kw["capacity"])
    cap_vis = max(int(cap * float(model_config(cell).get(
        "eval_visibility_frac", 1.0))), 16)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    with torch.no_grad():
        while time.perf_counter() < t_end:
            if i == 0:
                if traced:
                    common.sync(device)
                    t = time.perf_counter()
                r.prepare_image()
                if traced:
                    common.sync(device)
                    spans.append(time.perf_counter() - t)
            out = r.chunk_out(i)
            m = out["ray_included"].shape[0]
            n_rays += m
            dropped += (~out["ray_included"]).sum()
            if i in wanted and i not in kept:
                kept[i] = {k: out[k].clone() for k in ("comp_rgb_full",
                                                       "ray_included")}
            if traced:
                # what the buffers kept: the march counts the live
                # samples of the rays it dropped too, and the texture
                # stage takes at most its share of the buffer
                stats.append((torch.clamp(out["stat_live"], max=cap),
                              torch.clamp(out["stat_vis"], max=cap_vis), m))
            i = (i + 1) % len(r.starts)
    common.sync(device)
    window_s = time.perf_counter() - t0
    peak = common.memory_peak(device)
    res = {"attempted": n_rays, "failed": int(dropped), "memory_peak": peak,
           "setup_s": setup_s, "rate": n_rays / window_s,
           "rate_unit": "rays/s"}
    log(f"window: {n_rays} rays in {window_s:.3f} s, {int(dropped)} dropped")

    if traced:
        work = sum(flops.split_render_chunk(r.dims, float(a), float(b), m)
                   for a, b, m in stats)
        def image():
            r.prepare_image()
            for j in range(len(r.starts)):
                r.chunk_out(j)

        with torch.no_grad(), common.traced_stretch(device, False) as dev:
            image()
        rec = launches.LaunchRecorder()
        with torch.no_grad(), common.traced_stretch(device, True) as st, \
                rec:
            image()
        res["trace"] = {
            "kind": "render", "device_events": dev["events"],
            "events": st["events"], "model_flops": work,
            "flops_seconds": window_s, "spans": {"bake_mips": spans},
            "launch_bytes": {k: rec.bytes_of(k) for k in launches.ENTRIES}}

    prog = {j: keep(v) for j, v in kept.items()}
    del r, kept
    common.free(device)
    t = time.perf_counter()
    ref = reference_answers(cell, seed, device, sorted(prog))
    log(f"reference {time.perf_counter() - t:.1f} s")
    res["numbers"] = _answers(prog, ref)
    return res
