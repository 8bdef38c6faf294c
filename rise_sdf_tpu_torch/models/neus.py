"""NeuS renderer: geometry + radiance, no PBR (counterpart of
``rise_sdf_tpu/models/neus.py:NeuSModel``, without the learned
background, the visibility prefilter and the eval bake)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import make, register
from .variance import Variance
from ..ops import march, volrend


def _normalize(v, eps=1e-6):
    """Zero-safe normalize (finite gradient at v = 0)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps * eps)


def neus_alpha(sdf, inv_s, true_cos, dists, cos_anneal_ratio):
    """NeuS section-CDF alpha."""
    iter_cos = -(
        F.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
        + F.relu(-true_cos) * cos_anneal_ratio
    )
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5),
                       0.0, 1.0)


def occ_eval_alpha(sdf, inv_s, step_size):
    """Occupancy-grid alpha probe."""
    prev_cdf = torch.sigmoid((sdf + step_size * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf - step_size * 0.5) * inv_s)
    return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5),
                       0.0, 1.0)


@register("neus")
class NeuSModel(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        if bool(config.get("learned_background", False)):
            raise NotImplementedError("learned background is not ported yet")
        self.radius = float(config["radius"])
        self.num_samples_per_ray = int(config["num_samples_per_ray"])
        self.render_step_size = 1.732 * 2 * self.radius \
            / self.num_samples_per_ray
        self.grid_resolution = int(config.get("grid_resolution", 128))
        self.cos_anneal_end = int(config.get("cos_anneal_end", 0))
        self.randomized = bool(config.get("randomized", True))
        self.register_buffer("aabb_min", torch.full((3,), -self.radius),
                             persistent=False)
        self.register_buffer("aabb_max", torch.full((3,), self.radius),
                             persistent=False)
        self.geometry = make(config["geometry"]["name"], config["geometry"])
        self.texture = make(config["texture"]["name"], config["texture"])
        self.variance = Variance(config["variance"])

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh init, drawn from ``generator`` in a fixed module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def cos_anneal_ratio(self, step) -> float:
        if self.cos_anneal_end == 0:
            return 1.0
        return min(1.0, float(step) / self.cos_anneal_end)

    def open_levels(self, step: int):
        """Open hash levels of the geometry at ``step`` (None when the
        grid is not progressive)."""
        return self.geometry.open_levels(step)

    def post_update(self, step: int):
        """Buffer upkeep after the optimizer step (the variance's)."""
        self.variance.post_update(step)

    def forward_level(self, x, step=None):
        """The geometry's SDF level at ``x`` (mesh export)."""
        return self.geometry.forward_level(x, step)

    def occ_eval(self, x, step):
        """Per-cell occupancy alpha for the grid EMA update."""
        sdf = self.geometry.sdf(x, step)
        return occ_eval_alpha(sdf, self.variance.inv_s(),
                              self.render_step_size)

    def forward(self, rays, *, occ_binary, step, generator=None,
                train: bool = False, capacity: int, background_color,
                levels=None):
        """rays [R,6] -> per-ray render dict.  ``generator`` stratifies the
        march (training only); None gives mid-interval samples.
        ``levels``: the open hash levels (None: all, masked by step)."""
        n_rays = rays.shape[0]
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        march_gen = generator if (self.randomized and train) else None
        rs = march.march_rays(
            rays_o, rays_d, aabb_min=self.aabb_min, aabb_max=self.aabb_max,
            step_size=self.render_step_size,
            num_samples=self.num_samples_per_ray, capacity=capacity,
            grid_binary=occ_binary, grid_resolution=self.grid_resolution,
            generator=march_gen)
        t_mid = 0.5 * (rs.t_starts + rs.t_ends)
        dists = rs.t_ends - rs.t_starts
        ridx = torch.clamp(rs.ray_indices, 0, n_rays - 1)
        t_dirs = rays_d[ridx]
        positions = rays_o[ridx] + t_dirs * t_mid[:, None]

        geo = self.geometry(positions, step, with_grad=True,
                            with_feature=True, create_graph=train,
                            levels=levels)
        sdf, sdf_grad, feature = geo["sdf"], geo["grad"], geo["feature"]
        normal = _normalize(sdf_grad)
        inv_s = self.variance.inv_s()
        true_cos = torch.sum(t_dirs * normal, -1)
        alpha = neus_alpha(sdf, inv_s, true_cos, dists,
                           self.cos_anneal_ratio(step))
        rgb = self.texture(feature, t_dirs, normal, step=step)

        weights, _ = volrend.render_weight_from_alpha(
            alpha, rs.ray_start, rs.ray_indices, rs.valid, n_rays,
            deterministic=not train)
        packed = torch.cat([rgb, normal, t_mid[:, None],
                            torch.ones_like(t_mid)[:, None]], dim=-1)
        acc = volrend.accumulate_along_rays(weights, rs.ray_indices, packed,
                                            n_rays, deterministic=not train)
        comp_rgb, comp_normal = acc[:, 0:3], acc[:, 3:6]
        depth, opacity = acc[:, 6:7], acc[:, 7:8]
        bg = background_color[None, :].expand_as(comp_rgb)
        out = {
            "comp_rgb": comp_rgb,
            "comp_normal": _normalize(comp_normal),
            "opacity": opacity,
            "depth": depth,
            "rays_valid": opacity > 0,
            "num_samples": rs.num_live,
            "ray_included": rs.ray_included,
            "comp_rgb_full": comp_rgb + bg * (1.0 - opacity),
            "rays_valid_full": opacity > 0,
            "inv_s": inv_s,
        }
        if train:
            out.update({
                "sdf_samples": sdf,
                "sdf_grad_samples": sdf_grad,
                "samples_valid": rs.valid,
                "weights": weights,
                "points": t_mid,
                "intervals": dists,
                "ray_indices": rs.ray_indices,
                "ray_start": rs.ray_start,
            })
        return out
