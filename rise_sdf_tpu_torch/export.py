"""Mesh and material export (counterpart of ``rise_sdf_tpu/export.py``).

Coarse to fine marching over the SDF: a coarse pass over [-r, r]^3 at
min(resolution, 128) finds the object's box, a fine pass over the box +
10 % (clipped to [-r, r]^3) at ``isosurface.resolution`` extracts the
mesh.  The level grid is evaluated on the model's device in chunks of
``isosurface.chunk`` points (``forward_level``: the SDF alone, the hash
encode through G1 on the card) and stays there for marching tetrahedra
(``ops/mcubes.py``).  The vertex attributes are baked by chunked field
evaluations: the normal from the geometry's configured gradient, and
for the PBR model albedo, metallic and roughness seen along -normal at
stage 1 under the learned emitter's mips; for NeuS the radiance seen
along -normal (a pseudo-albedo vertex colour).

The box's bounds and the index-to-world scale are computed in numpy
float32 exactly as the JAX package does, so both packages put the
same vertices at the same world positions.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .ops.mcubes import marching_tets


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def _grid_levels(model, step, vmin, vmax, resolution: int, chunk: int,
                device) -> torch.Tensor:
    """The SDF on the ``resolution``^3 grid spanning [vmin, vmax] (axes
    as ``np.linspace`` in float32, x slowest), evaluated in chunks of
    ``chunk`` points on ``device``; returns [R, R, R] there."""
    r = resolution
    axes = [torch.from_numpy(np.linspace(vmin[i], vmax[i], r,
                                         dtype=np.float32)).to(device)
            for i in range(3)]
    n = r ** 3
    level = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        idx = torch.arange(s, min(s + chunk, n), device=device)
        pts = torch.stack([axes[0][idx // (r * r)], axes[1][(idx // r) % r],
                           axes[2][idx % r]], -1)
        level[s:s + idx.shape[0]] = model.forward_level(pts, step)
    return level.reshape(r, r, r)


def isosurface(model, state, config,
               times: Optional[Dict[str, float]] = None
               ) -> Optional[Dict[str, torch.Tensor]]:
    """``{"v_pos": [V, 3], "t_pos_idx": [F, 3]}`` on the model's device,
    or None without an ``isosurface`` config or a surface.  ``times``,
    when given, gets the seconds of the grid evaluations (``grid``) and
    of marching (``march``), both passes summed."""
    iso = config["model"]["geometry"].get("isosurface", None)
    if iso is None:
        return None
    resolution = int(iso.get("resolution", 512))
    chunk = int(iso.get("chunk", 2097152))
    threshold = float(iso.get("threshold", 0.0))
    radius = float(config["model"]["radius"])
    step = int(state["step"])
    device = next(model.parameters()).device
    times = {} if times is None else times
    times.setdefault("grid", 0.0)
    times.setdefault("march", 0.0)

    def run(vmin, vmax, res):
        _sync(device)
        t0 = time.perf_counter()
        level = _grid_levels(model, step, vmin, vmax, res, chunk, device)
        _sync(device)
        t1 = time.perf_counter()
        verts_idx, faces = marching_tets(level, threshold)
        del level
        _sync(device)
        times["grid"] += t1 - t0
        times["march"] += time.perf_counter() - t1
        if verts_idx.shape[0] == 0:
            return None
        scale = np.asarray([(vmax[i] - vmin[i]) / (res - 1)
                            for i in range(3)], np.float32)
        verts = verts_idx * torch.from_numpy(scale).to(device)[None, :] \
            + torch.from_numpy(np.asarray(vmin, np.float32)).to(device)
        return {"v_pos": verts, "t_pos_idx": faces}

    coarse = run([-radius] * 3, [radius] * 3, min(resolution, 128))
    if coarse is None:
        return None
    v = coarse["v_pos"].cpu().numpy()
    vmin, vmax = v.min(0), v.max(0)
    pad = (vmax - vmin) * 0.1
    vmin = np.clip(vmin - pad, -radius, radius)
    vmax = np.clip(vmax + pad, -radius, radius)
    return run(vmin, vmax, resolution)


def export_mesh(model, state, config,
                times: Optional[Dict[str, float]] = None
                ) -> Optional[Dict[str, np.ndarray]]:
    """The mesh and its baked vertex attributes as host arrays: ``v_pos``,
    ``t_pos_idx``, ``v_rgb`` and, for the PBR model, ``albedo``,
    ``metallic`` and ``roughness``; None without a surface.  Call it with
    the parameters frozen (``BaseSystem.frozen_params``): the normals'
    gradient is taken with respect to the points alone.  ``times`` also
    gets the attribute bake's seconds (``attributes``)."""
    times = {} if times is None else times
    mesh = isosurface(model, state, config, times)
    if mesh is None:
        return None
    export_cfg = config.get("export", {})
    if export_cfg.get("export_vertex_color", True):
        device = mesh["v_pos"].device
        _sync(device)
        t0 = time.perf_counter()
        mesh.update(bake_attributes(model, int(state["step"]),
                                    mesh["v_pos"], export_cfg))
        _sync(device)
        times["attributes"] = time.perf_counter() - t0
    return {k: v.cpu().numpy() for k, v in mesh.items()}


def bake_attributes(model, step, verts,
                    export_cfg) -> Dict[str, torch.Tensor]:
    """The vertex attributes at ``verts`` [V, 3], in chunks of
    min(``export.chunk_size``, 262,144): ``v_rgb`` and, for the PBR
    model, ``albedo``, ``metallic`` and ``roughness``."""
    chunk = min(int(export_cfg.get("chunk_size", 2097152)), 262144)
    has_pbr = hasattr(model, "emitter")
    with torch.no_grad():
        mips = model.emitter.build_mips() if has_pbr else None
    out = {"v_rgb": [], "albedo": [], "metallic": [], "roughness": []}
    for s in range(0, verts.shape[0], chunk):
        block = verts[s:s + chunk]
        geo = model.geometry(block, step, with_grad=True, with_feature=True)
        with torch.no_grad():
            normal = geo["grad"]
            normal = normal / torch.clamp(torch.linalg.vector_norm(
                normal, dim=-1, keepdim=True), min=1e-6)
            if has_pbr:
                tex = model.texture.apply(
                    geo["feature"], -normal, normal, block,
                    emitter=model.emitter, mips=mips, stage=1, step=step)
                for k in ("albedo", "metallic", "roughness"):
                    out[k].append(tex[k])
                out["v_rgb"].append(tex["albedo"])
            else:
                out["v_rgb"].append(model.texture(geo["feature"], -normal,
                                                  normal, step=step))
    return {k: torch.cat(v) for k, v in out.items() if v}
