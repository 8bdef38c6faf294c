"""The reference's family of volume-rendering drivers over the compacted
sample buffer (counterpart of ``rise_sdf_tpu/ops/rendering_drivers.py``).

Each driver takes a ``RaySamples`` buffer (``ops/march.py``) and a
``field_fn(t_starts, t_ends, ray_indices) -> dict`` of per-sample
channels, weighs the samples by ``ops/volrend.py``'s transmittance and
accumulates the variant's channels per ray:

=============================== ========================================
rendering                        rgb, alpha (or sigma)
rendering_with_normals           + normal
rendering_with_normals_sdf       + sdf, sdf_grad (laplace optional)
rendering_with_normals_mats      + albedo, roughness, metallic
rendering_with_normals_mats_sdf  the union of the above
..._mats_sdf_dir                 + the view directions per sample
=============================== ========================================

The models fuse their own accumulation, so nothing in either package
calls these yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from . import volrend
from .march import RaySamples


def _alpha_from(field_out, dists):
    if "alpha" in field_out:
        return field_out["alpha"]
    return 1.0 - torch.exp(-field_out["sigma"] * dists)


def _weights(rs: RaySamples, field_out, n_rays: int):
    dists = rs.t_ends - rs.t_starts
    alpha = torch.where(rs.valid, _alpha_from(field_out, dists), 0.0)
    weights, trans = volrend.render_weight_from_alpha(
        alpha, rs.ray_start, rs.ray_indices, rs.valid, n_rays)
    return alpha, weights, trans


def _render(rs: RaySamples, field_fn: Callable, n_rays: int, channel_keys,
            render_bkgd=None, extras_keys=()) -> Dict[str, torch.Tensor]:
    out = field_fn(rs.t_starts, rs.t_ends, rs.ray_indices)
    alpha, weights, trans = _weights(rs, out, n_rays)
    chans = [out[k][:, None] if out[k].dim() == 1 else out[k]
             for k in channel_keys]
    t_mid = 0.5 * (rs.t_starts + rs.t_ends)
    acc = volrend.accumulate_along_rays(
        weights, rs.ray_indices,
        torch.cat(chans + [t_mid[:, None], torch.ones_like(t_mid)[:, None]],
                  -1), n_rays)
    res, i = {}, 0
    for k, v in zip(channel_keys, chans):
        res[f"comp_{k}"] = acc[:, i:i + v.shape[-1]]
        i += v.shape[-1]
    opacity = acc[:, i + 1:i + 2]
    res.update({"depth": acc[:, i:i + 1], "opacity": opacity,
                "weights": weights, "trans": trans, "alphas": alpha,
                "ray_included": rs.ray_included})
    if render_bkgd is not None and "comp_rgb" in res:
        res["comp_rgb"] = res["comp_rgb"] + render_bkgd[None, :] \
            * (1.0 - opacity)
    for k in extras_keys:
        if k in out:
            res[f"{k}_samples"] = out[k]
    return res


SDF_EXTRAS = ("sdf", "sdf_grad", "laplace")
MATS = ["rgb", "normal", "albedo", "roughness", "metallic"]


def rendering(rs, field_fn, n_rays, render_bkgd=None):
    """nerfacc's base driver: colour, depth and opacity."""
    return _render(rs, field_fn, n_rays, ["rgb"], render_bkgd)


def rendering_with_normals(rs, field_fn, n_rays, render_bkgd=None):
    """... and the accumulated normals."""
    return _render(rs, field_fn, n_rays, ["rgb", "normal"], render_bkgd)


def rendering_with_normals_sdf(rs, field_fn, n_rays, render_bkgd=None):
    """... and the per-sample sdf, gradient and Laplacian passed on."""
    return _render(rs, field_fn, n_rays, ["rgb", "normal"], render_bkgd,
                   extras_keys=SDF_EXTRAS)


def rendering_with_normals_mats(rs, field_fn, n_rays, render_bkgd=None):
    """... and the accumulated albedo, roughness and metallic maps."""
    return _render(rs, field_fn, n_rays, MATS, render_bkgd)


def rendering_with_normals_mats_sdf(rs, field_fn, n_rays, render_bkgd=None):
    """The material maps and the sdf extras."""
    return _render(rs, field_fn, n_rays, MATS, render_bkgd,
                   extras_keys=SDF_EXTRAS)


def rendering_with_normals_mats_sdf_dir(rs, field_fn, n_rays, dirs,
                                        render_bkgd=None):
    """``rendering_with_normals_mats_sdf`` plus ``dirs`` [n_rays, 3]
    gathered to the samples (``dirs_samples``)."""
    res = rendering_with_normals_mats_sdf(rs, field_fn, n_rays, render_bkgd)
    res["dirs_samples"] = dirs[torch.clamp(rs.ray_indices, 0, n_rays - 1)]
    return res


def secondary_rendering(rs, alpha_fn, n_rays):
    """Opacity, depth and transmittance alone: the occlusion view of the
    field, no colour."""
    out = alpha_fn(rs.t_starts, rs.t_ends, rs.ray_indices)
    _, weights, _ = _weights(rs, out, n_rays)
    t_mid = 0.5 * (rs.t_starts + rs.t_ends)
    acc = volrend.accumulate_along_rays(
        weights, rs.ray_indices, torch.stack([t_mid, torch.ones_like(t_mid)],
                                             -1), n_rays)
    return {"depth": acc[:, 0:1], "opacity": acc[:, 1:2],
            "transmittance": 1.0 - acc[:, 1:2]}
