"""Split-mixed-occ renderer (counterpart of
``rise_sdf_tpu/models/split_mixed_occ.py:SplitMixedOccModel``).

The flagship's render: an optional coarse visibility probe (the
per-ray cut or the ``[t_lo, t_cut)`` band), occupancy-pruned marching
compacted into a fixed buffer (exactly ``band_k`` samples on banded
rays), the geometry, NeuS weights, the eval visibility compaction of
the texture stage, the five-head texture with split-sum shading, one
fused accumulation, and the secondary pass: transmittance along the
mirror rays (compacted to a fixed budget), blended with the secondary
radiance head; under ``relighting`` glossy pixels shade the third mirror
bounce under the given light instead.  ``forward_multi`` renders any
number of lights from one geometry pass.

Training (``train=True``) marches stratified when ``randomized``,
takes the configured gradient (hybrid finite differences for the
flagship) with the curvature probe, skips the visibility compaction and
returns the per-sample tensors the losses read.  The visibility probe
and the secondary transmittance and depth carry no gradient, as the
JAX package's ``stop_gradient`` leaves them; the secondary feature
encode and head do.

With a bake (``ops/sdf_bake.py``, ``eval_sdf_bake`` "probe" or "full")
the probe, and with "full" also the secondary transmittance, read the
corner-packed SDF table instead of the hash grid and the SDF MLP.

Every compaction keeps the JAX package's semantics: a cumsum gives each
kept entry its slot, the scatter sends the rest to one spare slot past
the buffer (``.at[dest].set(..., mode="drop")``), and a ray whose
entries overflow is reported in ``ray_included``.

Stages 0 and 1 are served; the sphere-traced ``forward_surface`` is not
ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import make, register
from .neus import _normalize, neus_alpha, occ_eval_alpha
from .variance import Variance
from ..ops import march, sdf_bake, volrend
from ..utils.color import rgb_to_srgb


def _compact(keep: torch.Tensor, cap: int):
    """Slots of the ``keep`` entries [M] in a ``cap`` buffer, in order.

    Returns ``(src [cap], valid [cap], pos_in_buf [M])``: ``src[j]`` is
    the index of the entry in slot ``j`` (0 in empty slots, as the JAX
    scatter into zeros leaves them), ``valid`` marks filled slots."""
    pos_in_buf = torch.cumsum(keep, 0) - 1
    dest = torch.where(keep & (pos_in_buf < cap), pos_in_buf, cap)
    src = torch.zeros(cap + 1, dtype=torch.int64, device=keep.device)
    src.scatter_(0, dest, torch.arange(keep.shape[0], device=keep.device))
    n_in = torch.clamp(pos_in_buf[-1] + 1, max=cap)
    valid = torch.arange(cap, device=keep.device) < n_in
    return src[:cap], valid, pos_in_buf


@register("split-mixed-occ")
class SplitMixedOccModel(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.radius = float(config["radius"])
        self.num_samples_per_ray = int(config["num_samples_per_ray"])
        self.render_step_size = 1.732 * 2 * self.radius \
            / self.num_samples_per_ray
        self.num_samples_per_secondary_ray = int(
            config.get("num_samples_per_secondary_ray", 96))
        self.secondary_near_plane = float(
            config.get("secondary_near_plane", 0.05))
        self.secondary_far_plane = float(
            config.get("secondary_far_plane", 1.5))
        self.secondary_sample_capacity_frac = float(
            config.get("secondary_sample_capacity_frac", 1.0))
        self.eval_visibility_frac = float(
            config.get("eval_visibility_frac", 1.0))
        self.grid_resolution = int(config.get("grid_resolution", 128))
        self.visibility_prefilter = bool(
            config.get("visibility_prefilter", False))
        self.prefilter_stride = int(config.get("prefilter_stride", 4))
        self.prefilter_coarse_per_ray = int(
            config.get("prefilter_coarse_per_ray", 64))
        self.prefilter_margin_intervals = float(
            config.get("prefilter_margin_intervals", 1.0))
        self.prefilter_levels = int(config.get("prefilter_levels", 0) or 0)
        self.eval_sdf_bake = str(config.get("eval_sdf_bake", "off") or "off")
        if self.eval_sdf_bake not in ("off", "probe", "full"):
            raise ValueError(f"eval_sdf_bake '{self.eval_sdf_bake}'")
        self.eval_sdf_bake_cells = int(config.get("eval_sdf_bake_cells", 128))
        self.eval_band_spr = int(config.get("eval_banded_samples_per_ray", 0))
        self.eval_band_reserve = int(config.get("eval_band_reserve", 0))
        self.eval_samples_per_ray = int(config.get("eval_samples_per_ray",
                                                   128))
        self.eval_band_exact = bool(config.get("eval_band_exact", True))
        if float(config.get("cone_angle", 0.0)) != 0.0:
            raise NotImplementedError("cone_angle marching is not ported yet")
        self.cos_anneal_end = int(config.get("cos_anneal_end", 0))
        self.randomized = bool(config.get("randomized", True))
        self.split_sum_kick_in_step = int(
            config.get("split_sum_kick_in_step", 0))
        self.indirect_pred = bool(config.get("indirect_pred", True))
        self.relighting_threshold = float(
            config.get("relighting_threshold", 0.3))
        self.register_buffer("aabb_min", torch.full((3,), -self.radius),
                             persistent=False)
        self.register_buffer("aabb_max", torch.full((3,), self.radius),
                             persistent=False)

        self.geometry = make(config["geometry"]["name"], config["geometry"])
        self.texture = make(config["texture"]["name"], config["texture"])
        self.emitter = make(config["light"]["name"], config["light"])
        self.variance = Variance(config["variance"])
        self.fd_grad = config["geometry"].get("grad_type") \
            == "finite_difference"

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Fresh init, drawn from ``generator`` in a fixed module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    # ------------------------------------------------------------------ #
    def stage(self, step: int) -> int:
        return 1 if step >= self.split_sum_kick_in_step else 0

    def open_levels(self, step: int):
        """Open hash levels of the geometry at ``step`` (None when the
        grid is not progressive)."""
        return self.geometry.open_levels(step)

    def post_update(self, step: int):
        """Buffer upkeep after the optimizer step (the variance's)."""
        self.variance.post_update(step)

    def cos_anneal_ratio(self, step) -> float:
        if self.cos_anneal_end == 0:
            return 1.0
        return min(1.0, float(step) / self.cos_anneal_end)

    def forward_level(self, x, step=None):
        """The geometry's SDF level at ``x`` (mesh export)."""
        return self.geometry.forward_level(x, step)

    def occ_eval(self, x, step, levels=None):
        sdf = self.geometry.sdf(x, step, levels=levels)
        return occ_eval_alpha(sdf, self.variance.inv_s(),
                              self.render_step_size)

    def prefilter_on(self, step: int, train: bool = True) -> bool:
        if not self.visibility_prefilter:
            return False
        start = int(self.config.get("prefilter_start_step",
                                    self.split_sum_kick_in_step))
        return (step >= start) if train else True

    def eval_options(self, step: int, chunk: int) -> dict:
        """The eval render's options for chunks of ``chunk`` rays at
        ``step``: the stage, the prefilter (always on at eval when
        configured) and, with it, banded marching into exactly
        ``eval_banded_samples_per_ray`` slots per banded ray plus
        ``eval_band_reserve``; else ``eval_samples_per_ray`` slots per
        ray."""
        pf = self.prefilter_on(step, train=False)
        banded = pf and self.eval_band_spr > 0
        cap = chunk * self.eval_band_spr + self.eval_band_reserve \
            if banded else chunk * self.eval_samples_per_ray
        return {"stage": self.stage(step), "prefilter": pf,
                "banded": banded, "capacity": cap}

    def bake_eval_sdf(self, step):
        """The full geometry SDF baked onto the eval grid, or None when
        ``eval_sdf_bake`` is "off"; pass it to ``forward`` as ``bake``."""
        return sdf_bake.bake_for_model(self, step)

    # ------------------------------------------------------------------ #
    def _alpha_at(self, positions, t_dirs, dists, step, cos_anneal_ratio,
                  levels=None, bake=None):
        if bake is not None and self.eval_sdf_bake == "full":
            sdf, grad = sdf_bake.sample_packed_grad(
                bake, positions, self.aabb_min, self.aabb_max)
        else:
            geo = self.geometry(positions, step, with_grad=True,
                                with_feature=False, grad_mode="analytic",
                                levels=levels)
            sdf, grad = geo["sdf"], geo["grad"]
        true_cos = torch.sum(t_dirs * _normalize(grad), -1)
        return neus_alpha(sdf, self.variance.inv_s(), true_cos, dists,
                          cos_anneal_ratio)

    def compute_indirect_radiance(self, rays_o, rays_d, occ_binary, step,
                                  levels=None, frac=None, bake=None):
        """``(1 - opacity, depth, included, live)`` along the secondary
        rays: ``num_samples_per_secondary_ray`` samples in [near, far],
        occupancy-masked; the live ones are compacted to ``frac`` of
        ``R * S`` slots before the alpha, and rays whose live samples
        overflow are excluded."""
        ts, te, live = march.march_rays_dense(
            rays_o, rays_d, near_plane=self.secondary_near_plane,
            far_plane=self.secondary_far_plane,
            num_samples=self.num_samples_per_secondary_ray,
            aabb_min=self.aabb_min, aabb_max=self.aabb_max,
            grid_binary=occ_binary, grid_resolution=self.grid_resolution)
        t_mid = 0.5 * (ts + te)
        dists = te - ts
        pos = rays_o[:, None, :] + rays_d[:, None, :] * t_mid[..., None]
        n, s = pos.shape[0], pos.shape[1]
        t_dirs = rays_d[:, None, :].expand_as(pos)

        frac = self.secondary_sample_capacity_frac if frac is None else frac
        cap = int(frac * n * s)
        if cap >= n * s:
            alpha = self._alpha_at(pos.reshape(-1, 3), t_dirs.reshape(-1, 3),
                                   dists.reshape(-1), step, 1.0, levels,
                                   bake).reshape(n, s)
            included = torch.ones((n,), dtype=torch.bool, device=pos.device)
        else:
            src, buf_valid, _ = _compact(live.reshape(-1), cap)
            a_c = self._alpha_at(pos.reshape(-1, 3).index_select(0, src),
                                 t_dirs.reshape(-1, 3).index_select(0, src),
                                 dists.reshape(-1).index_select(0, src),
                                 step, 1.0, levels, bake)
            a_c = torch.where(buf_valid, a_c, 0.0)
            alpha = a_c.new_zeros(n * s + 1).scatter_(
                0, torch.where(buf_valid, src, n * s), a_c)[:n * s]
            alpha = alpha.reshape(n, s)
            included = torch.cumsum(live.sum(dim=1), 0) <= cap
        alpha = torch.where(live, alpha, 0.0)
        w, _ = volrend.render_weight_from_alpha_dense(alpha, live)
        acc = w.sum(dim=1, keepdim=True)
        depth = (w * t_mid).sum(dim=1, keepdim=True)
        return torch.clamp(1.0 - acc, 0.0, 1.0), depth, included, live.sum()

    def _secondary_geom(self, rays_o, rays_d, occ_binary, step, *, levels,
                        secondary_frac, normal_map, depth_map, acc_map,
                        included, bake, need_third: bool = False):
        """The light-independent half of the secondary pass, computed once
        per geometry pass: transmittance and depth along the mirror rays,
        the secondary radiance head at the primary hit and, with
        ``need_third`` (relighting), the third-bounce hit ``sec_o +
        depth * sec_d``: its analytic normal (a gradient with respect to
        the positions only) and its material cache."""
        sec_valid = acc_map[:, 0] > 0.5
        if not self.indirect_pred:
            return {"included": included,
                    "sec_live": torch.zeros((), dtype=torch.int64,
                                            device=rays_o.device)}
        sec_o = rays_o + depth_map * rays_d
        wo = -rays_d
        sec_d = 2.0 * torch.sum(wo * normal_map, -1, keepdim=True) \
            * normal_map - wo
        with torch.no_grad():
            tr, sec_depth, sec_inc, sec_live = \
                self.compute_indirect_radiance(
                    sec_o, sec_d, occ_binary, step, levels=levels,
                    frac=secondary_frac, bake=bake)
        # overflow matters only where the secondary result is blended in
        included = included & (sec_inc | ~sec_valid)
        sec_geo = self.geometry(sec_o, step, with_grad=False,
                                with_feature=True, levels=levels)
        sec_rgb = self.texture.secondary_shading(
            sec_geo["feature"], sec_d, normal_map, step=step)
        sg = {"sec_valid": sec_valid, "tr": tr, "sec_rgb": sec_rgb,
              "sec_live": sec_live, "included": included}
        if need_third:
            third_o = sec_o + sec_depth * sec_d
            tg = self.geometry(third_o, step, with_grad=True,
                               with_feature=True, grad_mode="analytic",
                               levels=levels)
            sg["third_cache"] = self.texture.secondary_pbr_cache(
                tg["feature"], sec_d, _normalize(tg["grad"]), third_o,
                step=step)
        return sg

    def _secondary_shade(self, sg, maps, *, stage, relighting: bool = False,
                         mips=None):
        """The per-light half: blend the indirect radiance into the
        specular maps; when ``relighting``, glossy pixels (roughness at
        most ``relighting_threshold``) instead blend the third-bounce
        hit shaded under this light into the specular light."""
        maps = dict(maps)
        if not self.indirect_pred:
            return maps
        mask = sg["sec_valid"][:, None]
        tr, sec_rgb = sg["tr"], sg["sec_rgb"]
        maps["spec_rgb"] = torch.where(
            mask, tr * maps["spec_rgb"] + (1 - tr) * sec_rgb, maps["spec_rgb"])
        if stage == 0:
            return maps
        if not relighting:
            maps["spec_rgb_pbr"] = torch.where(
                mask, tr * maps["spec_rgb_pbr"] + (1 - tr) * sec_rgb,
                maps["spec_rgb_pbr"])
            return maps
        rough_mask = mask & (maps["roughness"] <= self.relighting_threshold)
        third_rgb = self.texture.secondary_shade_pbr_cached(
            sg["third_cache"], self.emitter, mips)
        maps["spec_light"] = torch.where(
            rough_mask, tr * maps["spec_light"] + (1 - tr) * third_rgb,
            maps["spec_light"])
        maps["spec_rgb_pbr"] = maps["spec_ref"] * maps["spec_light"]
        return maps

    @staticmethod
    def _assemble_out(*, diff_rgb_map, maps, blend_map, normal_map,
                      depth_map, acc_map, num_samples, included, inv_s,
                      background_color, stage, diff_rgb_pbr_map=None,
                      albedo_map=None, metallic_map=None):
        """The per-ray eval channels."""
        spec_rgb_map = maps["spec_rgb"]
        rgb_map = diff_rgb_map + spec_rgb_map
        bg = background_color[None, :].expand_as(rgb_map)

        def full(rgb):
            return torch.clamp(rgb_to_srgb(rgb + bg * (1.0 - acc_map)),
                               0.0, 1.0)

        out = {
            "comp_rgb": rgb_map,
            "comp_diffuse_rgb": diff_rgb_map,
            "comp_spec_rgb": spec_rgb_map,
            "comp_blend": blend_map,
            "comp_normal": normal_map,
            "opacity": acc_map,
            "depth": depth_map,
            "rays_valid": acc_map > 0,
            "num_samples": num_samples,
            "ray_included": included,
            "inv_s": inv_s,
            "comp_rgb_full": full(rgb_map),
            "rays_valid_full": acc_map > 0,
        }
        if stage != 0:
            spec_rgb_pbr_map = maps["spec_rgb_pbr"]
            rgb_pbr_map = diff_rgb_pbr_map + spec_rgb_pbr_map
            out.update({
                "comp_rgb_phys": rgb_pbr_map,
                "comp_diffuse_rgb_phys": diff_rgb_pbr_map,
                "comp_spec_rgb_phys": spec_rgb_pbr_map,
                "comp_albedo": albedo_map,
                "comp_metallic": metallic_map,
                "comp_roughness": maps["roughness"],
                "comp_rgb_phys_full": full(rgb_pbr_map),
                "comp_spec_rgb_full": full(spec_rgb_map),
                "comp_spec_rgb_phys_full": full(spec_rgb_pbr_map),
            })
        return out

    # ------------------------------------------------------------------ #
    def visibility_cut(self, rays_o, rays_d, occ_binary, step, levels=None,
                       cos_anneal_ratio=1.0, band: bool = False, bake=None,
                       deterministic: bool = False):
        """Per-ray transmittance cut, or the ``(t_lo, t_cut)`` band, from
        the coarse SDF probe (the bake's table when one is given);
        ``deterministic`` for an eval render (``ops/volrend.py``)."""
        n_rays = rays_o.shape[0]
        cap = n_rays * min(self.prefilter_coarse_per_ray,
                           max(self.num_samples_per_ray
                               // self.prefilter_stride, 1))
        if levels is None and self.prefilter_levels:
            levels = self.prefilter_levels
        if bake is not None and self.eval_sdf_bake != "off":
            def sdf_fn(p):
                return sdf_bake.sample_packed(bake, p, self.aabb_min,
                                              self.aabb_max)
        else:
            def sdf_fn(p):
                return self.geometry.sdf(p, step, levels=levels)
        return march.compute_visibility_cut(
            rays_o, rays_d, sdf_fn=sdf_fn, inv_s=self.variance.inv_s(),
            aabb_min=self.aabb_min, aabb_max=self.aabb_max,
            step_size=self.render_step_size,
            num_samples=self.num_samples_per_ray, capacity=cap,
            grid_binary=occ_binary, grid_resolution=self.grid_resolution,
            stride=self.prefilter_stride, cos_anneal_ratio=cos_anneal_ratio,
            early_stop_eps=volrend.EARLY_STOP_EPS,
            margin_intervals=self.prefilter_margin_intervals, band=band,
            deterministic=deterministic)

    def _march_compact(self, rays, *, occ_binary, step, train, capacity,
                       levels, prefilter, banded, vis_frac, bake, generator,
                       laplace_dirs):
        """Probe, march, geometry, NeuS weights and (eval) the visibility
        compaction of the samples that go to the texture stage."""
        n_rays = rays.shape[0]
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        t_cut = t_band_lo = None
        if prefilter and occ_binary is not None:
            with torch.no_grad():
                vc = self.visibility_cut(
                    rays_o, rays_d, occ_binary, step, levels=levels,
                    cos_anneal_ratio=self.cos_anneal_ratio(step),
                    band=banded, bake=bake, deterministic=not train)
            t_band_lo, t_cut = vc if banded else (None, vc)

        rs = march.march_rays(
            rays_o, rays_d, aabb_min=self.aabb_min, aabb_max=self.aabb_max,
            step_size=self.render_step_size,
            num_samples=self.num_samples_per_ray, capacity=capacity,
            grid_binary=occ_binary, grid_resolution=self.grid_resolution,
            generator=generator if (self.randomized and train) else None,
            t_cut=t_cut, t_band_lo=t_band_lo,
            band_k=(self.eval_band_spr
                    if (banded and self.eval_band_exact
                        and self.eval_band_spr > 0) else None))
        t_mid = 0.5 * (rs.t_starts + rs.t_ends)
        dists = rs.t_ends - rs.t_starts
        ridx = torch.clamp(rs.ray_indices, 0, n_rays - 1)
        t_dirs = rays_d.index_select(0, ridx)
        positions = rays_o.index_select(0, ridx) + t_dirs * t_mid[:, None]

        want_laplace = self.fd_grad and train
        if want_laplace and laplace_dirs is None:
            laplace_dirs = torch.rand(
                (-(-capacity // self.geometry.laplace_stride), 3),
                generator=generator, device=rays.device)
        geo = self.geometry(positions, step, with_grad=True,
                            with_feature=True, create_graph=train,
                            levels=levels,
                            grad_mode=None if train else "analytic",
                            with_laplace=want_laplace,
                            laplace_dirs=laplace_dirs)
        feature = geo["feature"]
        normal = _normalize(geo["grad"])
        inv_s = self.variance.inv_s()
        true_cos = torch.sum(t_dirs * normal, -1)
        alpha = neus_alpha(geo["sdf"], inv_s, true_cos, dists,
                           self.cos_anneal_ratio(step))
        weights, _ = volrend.render_weight_from_alpha(
            alpha, rs.ray_start, rs.ray_indices, rs.valid, n_rays,
            deterministic=not train)

        included = rs.ray_included
        frac = self.eval_visibility_frac if vis_frac is None \
            else float(vis_frac)
        vis = (weights > 1e-5) & rs.valid
        mc = {"rs": rs, "geo": geo, "weights": weights, "vis": vis,
              "inv_s": inv_s, "t_mid": t_mid, "dists": dists}
        if not train and frac < 1.0:
            # the texture stage runs only on samples of weight > 1e-5
            cap2 = max(int(capacity * frac), 16)
            src, bv, _ = _compact(vis, cap2)
            vis_cnt = torch.zeros(n_rays + 1, dtype=torch.int64,
                                  device=rays.device).index_add_(
                0, rs.ray_indices, vis.long())[:n_rays]
            included = included & (torch.cumsum(vis_cnt, 0) <= cap2)
            mc.update(
                s_feature=feature.index_select(0, src),
                s_dirs=t_dirs.index_select(0, src),
                s_normal=normal.index_select(0, src),
                s_pos=positions.index_select(0, src),
                s_tmid=t_mid.index_select(0, src),
                s_weights=torch.where(bv, weights.index_select(0, src), 0.0),
                s_ridx=torch.where(bv, rs.ray_indices.index_select(0, src),
                                   n_rays))
        else:
            mc.update(s_feature=feature, s_dirs=t_dirs, s_normal=normal,
                      s_pos=positions, s_tmid=t_mid, s_weights=weights,
                      s_ridx=rs.ray_indices)
        mc["included"] = included
        return mc

    @staticmethod
    def _split_maps(acc, names, widths):
        """Cut the accumulated ``acc`` [R, sum widths] into named maps."""
        maps, i = {}, 0
        for k, c in zip(names, widths):
            maps[k] = acc[:, i:i + c]
            i += c
        return maps

    def _eval_stats(self, out, mc, sec_live):
        """Eval-capacity statistics: live samples in the buffer, samples
        of weight > 1e-5 and live secondary samples (before compaction)."""
        out["stat_live"] = mc["rs"].num_live
        out["stat_vis"] = mc["vis"].sum()
        if self.indirect_pred:
            out["stat_secondary_live"] = sec_live

    def forward(self, rays, *, occ_binary, mips, step, stage: int = 0,
                train: bool = False, relighting: bool = False,
                capacity: int, background_color, levels=None,
                secondary_frac=None, prefilter: bool = False,
                vis_frac=None, banded: bool = False, bake=None,
                generator: Optional[torch.Generator] = None,
                laplace_dirs: Optional[torch.Tensor] = None):
        """rays [R, 6] -> per-ray dict.  ``mips`` is
        ``emitter.build_mips()``, ``bake`` the ``bake_eval_sdf`` table (or
        None); the other options are the JAX ``forward``'s.  Eval
        (``train=False``) runs under ``no_grad``, the geometry taking its
        analytic normals with respect to the sample positions only.
        ``relighting`` (eval, stage 1) shades the third mirror bounce of
        glossy pixels under ``mips`` (``_secondary_shade``).  Training
        draws the stratified march offsets (when ``randomized``) and the
        curvature probe's directions from ``generator``, unless
        ``laplace_dirs`` [ceil(capacity / laplace_stride), 3] gives the
        directions (uniform [0, 1)^3, as the JAX probe draws them)."""
        if relighting and train:
            raise ValueError("relighting is an eval render (train=False)")
        with torch.set_grad_enabled(train):
            mc = self._march_compact(
                rays, occ_binary=occ_binary, step=step, train=train,
                capacity=capacity, levels=levels, prefilter=prefilter,
                banded=banded, vis_frac=vis_frac, bake=bake,
                generator=generator, laplace_dirs=laplace_dirs)
            n_rays = rays.shape[0]
            rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
            rs = mc["rs"]
            s_dirs, s_normal = mc["s_dirs"], mc["s_normal"]
            s_tmid = mc["s_tmid"]

            tex = self.texture.apply(mc["s_feature"], s_dirs, s_normal,
                                     mc["s_pos"], emitter=self.emitter,
                                     mips=mips, stage=stage, step=step)
            names = ["diff_rgb", "spec_rgb", "blend"]
            if stage != 0:
                names += ["diff_rgb_pbr", "spec_rgb_pbr", "spec_ref",
                          "spec_light", "albedo", "metallic", "roughness"]
            chans = [tex[k] for k in names]
            norm_orient = torch.clamp(
                torch.sum(s_dirs * s_normal, -1, keepdim=True), min=0.0)
            chans += [s_normal, s_tmid[:, None],
                      torch.ones_like(s_tmid)[:, None], norm_orient]
            acc = volrend.accumulate_along_rays(
                mc["s_weights"], mc["s_ridx"], torch.cat(chans, dim=-1),
                n_rays, deterministic=not train)
            maps = self._split_maps(
                acc, names + ["normal", "depth", "acc", "norm_orient"],
                [c.shape[-1] for c in chans])

            sec_maps = {"spec_rgb": maps["spec_rgb"]}
            if stage != 0:
                sec_maps.update({k: maps[k] for k in (
                    "spec_rgb_pbr", "spec_ref", "spec_light", "roughness")})
            sg = self._secondary_geom(
                rays_o, rays_d, occ_binary, step, levels=levels,
                secondary_frac=secondary_frac, normal_map=maps["normal"],
                depth_map=maps["depth"], acc_map=maps["acc"],
                included=mc["included"], bake=bake,
                need_third=stage != 0 and relighting)
            sec_maps = self._secondary_shade(sg, sec_maps, stage=stage,
                                             relighting=relighting, mips=mips)
            out = self._assemble_out(
                diff_rgb_map=maps["diff_rgb"], maps=sec_maps,
                blend_map=maps["blend"], normal_map=maps["normal"],
                depth_map=maps["depth"], acc_map=maps["acc"],
                num_samples=rs.num_live, included=sg["included"],
                inv_s=mc["inv_s"], background_color=background_color,
                stage=stage, diff_rgb_pbr_map=maps.get("diff_rgb_pbr"),
                albedo_map=maps.get("albedo"),
                metallic_map=maps.get("metallic"))
            if not train:
                self._eval_stats(out, mc, sg["sec_live"])
                return out
            geo = mc["geo"]
            out.update({
                "sdf_samples": geo["sdf"],
                "sdf_grad_samples": geo["grad"],
                "samples_valid": rs.valid,
                "weights": mc["weights"],
                "points": mc["t_mid"],
                "intervals": mc["dists"],
                "ray_indices": rs.ray_indices,
                "ray_start": rs.ray_start,
                "normals_orientation_loss_map": maps["norm_orient"],
            })
            if "laplace" in geo:
                # the probe ran on every laplace_stride-th sample
                out["sdf_laplace_samples"] = geo["laplace"]
                out["sdf_laplace_valid"] = \
                    rs.valid[::self.geometry.laplace_stride]
            return out

    @torch.no_grad()
    def forward_multi(self, rays, *, occ_binary, mips_list, step,
                      relight_flags, stage: int = 1, capacity: int,
                      background_color, levels=None, secondary_frac=None,
                      vis_frac=None, prefilter: bool = False,
                      banded: bool = False, bake=None):
        """Multi-emitter eval: one geometry pass (march, geometry, NeuS
        weights, visibility compaction, the material heads, the
        secondary transmittance and the third-bounce hit) shaded under
        each of ``mips_list``; returns one ``forward``-style dict per
        light.  ``relight_flags[i]`` pairs with ``mips_list[i]`` (False:
        the training emitter's render; True: a relight render with the
        third bounce).  Per light only ``shade_cached`` (two mip-cubemap
        lookups), a 9-channel accumulation and ``_secondary_shade`` run;
        the same helpers as ``forward`` give the same numbers.  The
        calibration statistics ride on output 0."""
        if len(mips_list) != len(relight_flags) or not mips_list:
            raise ValueError("one relight flag per mips, at least one")
        n_rays = rays.shape[0]
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        mc = self._march_compact(
            rays, occ_binary=occ_binary, step=step, train=False,
            capacity=capacity, levels=levels, prefilter=prefilter,
            banded=banded, vis_frac=vis_frac, bake=bake, generator=None,
            laplace_dirs=None)
        s_weights, s_ridx = mc["s_weights"], mc["s_ridx"]
        s_normal, s_tmid = mc["s_normal"], mc["s_tmid"]
        texc = self.texture.material_cache(
            mc["s_feature"], mc["s_dirs"], s_normal, mc["s_pos"],
            stage=stage, step=step)

        # the light-independent channels, accumulated once
        names = ["diff_rgb", "spec_rgb", "blend"]
        if stage != 0:
            names += ["spec_ref", "albedo", "metallic", "roughness"]
        chans = [texc[k] for k in names]
        chans += [s_normal, s_tmid[:, None], torch.ones_like(s_tmid)[:, None]]
        acc = volrend.accumulate_along_rays(
            s_weights, s_ridx, torch.cat(chans, dim=-1), n_rays,
            deterministic=True)
        maps = self._split_maps(acc, names + ["normal", "depth", "acc"],
                                [c.shape[-1] for c in chans])
        sg = self._secondary_geom(
            rays_o, rays_d, occ_binary, step, levels=levels,
            secondary_frac=secondary_frac, normal_map=maps["normal"],
            depth_map=maps["depth"], acc_map=maps["acc"],
            included=mc["included"], bake=bake,
            need_third=stage != 0 and any(relight_flags))

        outs = []
        for mips, relighting in zip(mips_list, relight_flags):
            sec_maps = {"spec_rgb": maps["spec_rgb"]}
            diff_rgb_pbr_map = None
            if stage != 0:
                shade = self.texture.shade_cached(texc, self.emitter, mips,
                                                  stage=stage)
                acc_l = volrend.accumulate_along_rays(
                    s_weights, s_ridx,
                    torch.cat([shade["diff_rgb_pbr"], shade["spec_rgb_pbr"],
                               shade["spec_light"]], -1), n_rays,
                    deterministic=True)
                diff_rgb_pbr_map = acc_l[:, 0:3]
                sec_maps.update(spec_rgb_pbr=acc_l[:, 3:6],
                                spec_light=acc_l[:, 6:9],
                                spec_ref=maps["spec_ref"],
                                roughness=maps["roughness"])
            sec_maps = self._secondary_shade(sg, sec_maps, stage=stage,
                                             relighting=relighting, mips=mips)
            outs.append(self._assemble_out(
                diff_rgb_map=maps["diff_rgb"], maps=sec_maps,
                blend_map=maps["blend"], normal_map=maps["normal"],
                depth_map=maps["depth"], acc_map=maps["acc"],
                num_samples=mc["rs"].num_live, included=sg["included"],
                inv_s=mc["inv_s"], background_color=background_color,
                stage=stage, diff_rgb_pbr_map=diff_rgb_pbr_map,
                albedo_map=maps.get("albedo"),
                metallic_map=maps.get("metallic")))
        self._eval_stats(outs[0], mc, sg["sec_live"])
        return outs
