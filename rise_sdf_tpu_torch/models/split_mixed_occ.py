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

Every compaction keeps the JAX package's semantics (a cumsum gives each
kept entry its slot, the rest go to one spare slot past the buffer,
``.at[dest].set(..., mode="drop")``, and a ray whose entries overflow
is reported in ``ray_included``), as a gather: each slot finds its
entry by ``searchsorted`` of the cumsum, which fills the same slots
with the same bits and has no shared slot to write.

With ``eval_mode: sphere_trace`` an eval renders through
``forward_surface`` (and ``forward_surface_multi``) instead: a
fixed-iteration sphere trace of the hash-grid SDF
(``ops/sphere_trace.py``) finds one hit per ray, which the same texture
and secondary pass shade, with the same eval channels.  An occupancy
guard flags rays the trace may have tunnelled through; those and the
unresolved rays leave ``ray_included`` False, and the system re-renders
them volumetrically.  Any other ``eval_mode`` renders volumetrically,
as in the JAX package, which does not refuse a misspelt mode.

Stages 0 and 1 are served.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import make, register
from .. import trace
from .neus import _normalize, neus_alpha, occ_eval_alpha
from .variance import Variance
from ..ops import march, sdf_bake, volrend
from ..ops.scatter_sorted import index_select
from ..ops.sphere_trace import sphere_trace
from ..utils.color import rgb_to_srgb


def _compact(keep: torch.Tensor, cap: int):
    """Slots of the ``keep`` entries [M] in a ``cap`` buffer, in order.

    Returns ``(src [cap], valid [cap], pos_in_buf [M])``: ``src[j]`` is
    the index of the entry in slot ``j`` (0 in empty slots, as the JAX
    scatter into zeros leaves them), ``valid`` marks filled slots."""
    pos_in_buf = torch.cumsum(keep, 0) - 1
    n_in = torch.clamp(pos_in_buf[-1] + 1, max=cap)
    valid = torch.arange(cap, device=keep.device) < n_in
    # slot j's entry is the (j+1)-th kept one: a gather (torch's
    # deterministic scatter would write the dropped entries' shared slot
    # one by one)
    src = torch.searchsorted(pos_in_buf + 1, torch.arange(
        1, cap + 1, device=keep.device))
    return torch.where(valid, src, 0), valid, pos_in_buf


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
        self.cone_angle = float(config.get("cone_angle", 0.0))
        # the sphere-traced eval (``forward_surface``), chosen with
        # ``eval_mode: sphere_trace``; any other mode renders volumetrically
        self.eval_mode = str(config.get("eval_mode", "volume"))
        self.st_iters = int(config.get("sphere_trace_iters", 48))
        self.st_refine = int(config.get("sphere_trace_refine_iters", 4))
        self.st_hit_eps = float(config.get("sphere_trace_hit_eps", 1e-3))
        self.st_relax = float(config.get("sphere_trace_relax", 0.9))
        self.st_occ_guard = bool(config.get("sphere_trace_occ_guard", True))
        # a surface's own occupied lead: ~2 cells of dilation plus the
        # cell-centre slop, stretched by the eikonal residual
        self.st_guard_margin = float(
            config.get("sphere_trace_guard_margin_cells", 4.0))
        # a miss whose least SDF clears k / inv_s (0 turns the gate off)
        # carries no NeuS weight anywhere: its occupied cells are the
        # grid's dilation, not a tunnelled surface
        self.st_sdf_clearance = float(
            config.get("sphere_trace_sdf_clearance", 4.0))
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
        return occ_eval_alpha(sdf, self.variance.inv_s(step),
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

    @trace.spanned("eval.bake")
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
        return neus_alpha(sdf, self.variance.inv_s(step), true_cos, dists,
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
            src, _, pos_in_buf = _compact(live.reshape(-1), cap)
            a_c = self._alpha_at(index_select(pos.reshape(-1, 3), src),
                                 index_select(t_dirs.reshape(-1, 3), src),
                                 index_select(dists.reshape(-1), src),
                                 step, 1.0, levels, bake)
            # each kept sample gathers its slot
            kept = live.reshape(-1) & (pos_in_buf < cap)
            alpha = torch.where(kept, index_select(
                a_c, torch.clamp(pos_in_buf, 0, cap - 1)), 0.0)
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
            rays_o, rays_d, sdf_fn=sdf_fn, inv_s=self.variance.inv_s(step),
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
            with torch.no_grad(), trace.span("model.visibility"):
                vc = self.visibility_cut(
                    rays_o, rays_d, occ_binary, step, levels=levels,
                    cos_anneal_ratio=self.cos_anneal_ratio(step),
                    band=banded, bake=bake, deterministic=not train)
            t_band_lo, t_cut = vc if banded else (None, vc)

        with trace.span("model.march"):
            rs = march.march_rays(
                rays_o, rays_d, aabb_min=self.aabb_min, aabb_max=self.aabb_max,
                step_size=self.render_step_size,
                num_samples=self.num_samples_per_ray, capacity=capacity,
                grid_binary=occ_binary, grid_resolution=self.grid_resolution,
                generator=generator if (self.randomized and train) else None,
                t_cut=t_cut, t_band_lo=t_band_lo,
                band_k=(self.eval_band_spr
                        if (banded and self.eval_band_exact
                            and self.eval_band_spr > 0) else None),
                cone_angle=self.cone_angle)
        t_mid = 0.5 * (rs.t_starts + rs.t_ends)
        dists = rs.t_ends - rs.t_starts
        ridx = torch.clamp(rs.ray_indices, 0, n_rays - 1)
        t_dirs = index_select(rays_d, ridx)
        positions = index_select(rays_o, ridx) + t_dirs * t_mid[:, None]

        want_laplace = self.fd_grad and train
        if want_laplace and laplace_dirs is None:
            laplace_dirs = torch.rand(
                (-(-capacity // self.geometry.laplace_stride), 3),
                generator=generator, device=rays.device)
        with trace.span("model.geometry"):
            geo = self.geometry(positions, step, with_grad=True,
                                with_feature=True, create_graph=train,
                                levels=levels,
                                grad_mode=None if train else "analytic",
                                with_laplace=want_laplace,
                                laplace_dirs=laplace_dirs)
            feature = geo["feature"]
            normal = _normalize(geo["grad"])
        with trace.span("model.weights"):
            inv_s = self.variance.inv_s(step)
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
            mc["shaded_most"] = cap2
            with trace.span("model.compact"):
                src, bv, _ = _compact(vis, cap2)
                vis_cnt = torch.zeros(n_rays + 1, dtype=torch.int64,
                                      device=rays.device).index_add_(
                    0, rs.ray_indices, vis.long())[:n_rays]
                included = included & (torch.cumsum(vis_cnt, 0) <= cap2)
                mc.update(
                    s_feature=index_select(feature, src),
                    s_dirs=index_select(t_dirs, src),
                    s_normal=index_select(normal, src),
                    s_pos=index_select(positions, src),
                    s_tmid=index_select(t_mid, src),
                    s_weights=torch.where(bv, index_select(weights, src), 0.0),
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
        """Eval-capacity statistics: live samples before the buffer,
        samples of weight > 1e-5 and live secondary samples (before
        compaction).  ``stat_live`` is the march's count, which takes in
        the samples of the rays it dropped; the tracer's
        ``model.samples_kept`` is what the buffer kept (``_count``)."""
        out["stat_live"] = mc["rs"].num_live
        out["stat_vis"] = mc["vis"].sum()
        if self.indirect_pred:
            out["stat_secondary_live"] = sec_live

    @staticmethod
    def _count(out, mc, capacity):
        """The tracer's counters of one forward: the live samples the
        buffer kept, the rays included and the samples the texture stage
        shaded (those kept by the eval compaction, when it runs)."""
        live = mc["rs"].num_live
        trace.count("model.samples_kept", live, most=capacity)
        trace.count("model.rays_included", out["ray_included"])
        if "shaded_most" in mc:
            trace.count("model.samples_shaded", mc["vis"],
                        most=mc["shaded_most"])
        else:
            trace.count("model.samples_shaded", live, most=capacity)

    @trace.spanned("model.forward")
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

            with trace.span("model.texture"):
                tex = self.texture.apply(mc["s_feature"], s_dirs, s_normal,
                                         mc["s_pos"], emitter=self.emitter,
                                         mips=mips, stage=stage, step=step)
            names = ["diff_rgb", "spec_rgb", "blend"]
            if stage != 0:
                names += ["diff_rgb_pbr", "spec_rgb_pbr", "spec_ref",
                          "spec_light", "albedo", "metallic", "roughness"]
            with trace.span("model.accumulate"):
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
            with trace.span("model.secondary"):
                sg = self._secondary_geom(
                    rays_o, rays_d, occ_binary, step, levels=levels,
                    secondary_frac=secondary_frac, normal_map=maps["normal"],
                    depth_map=maps["depth"], acc_map=maps["acc"],
                    included=mc["included"], bake=bake,
                    need_third=stage != 0 and relighting)
                sec_maps = self._secondary_shade(
                    sg, sec_maps, stage=stage, relighting=relighting,
                    mips=mips)
            out = self._assemble_out(
                diff_rgb_map=maps["diff_rgb"], maps=sec_maps,
                blend_map=maps["blend"], normal_map=maps["normal"],
                depth_map=maps["depth"], acc_map=maps["acc"],
                num_samples=rs.num_live, included=sg["included"],
                inv_s=mc["inv_s"], background_color=background_color,
                stage=stage, diff_rgb_pbr_map=maps.get("diff_rgb_pbr"),
                albedo_map=maps.get("albedo"),
                metallic_map=maps.get("metallic"))
            if trace.on():
                self._count(out, mc, capacity)
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

    # ------------------------------------------------------------------ #
    def _surface_geometry(self, rays, *, occ_binary, step, levels):
        """The light-independent front of the sphere-traced eval: the
        trace on the hash-grid SDF, the hit's geometry (analytic normal
        and feature) and the occupancy tunnelling guard."""
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        res = sphere_trace(
            rays_o, rays_d,
            sdf_fn=lambda p: self.geometry.sdf(p, step, levels=levels),
            aabb_min=self.aabb_min, aabb_max=self.aabb_max,
            n_iters=self.st_iters, refine_iters=self.st_refine,
            hit_eps=self.st_hit_eps, relax=self.st_relax)
        hit, included = res.hit, res.converged
        pos = rays_o + rays_d * res.t_hit[:, None]
        geo = self.geometry(pos, step, with_grad=True, with_feature=True,
                            grad_mode="analytic", levels=levels)
        normal = _normalize(geo["grad"])
        if occ_binary is not None and self.st_occ_guard:
            # the trace can step over a thin sheet where the learned SDF
            # overestimates the distance, and then reports a clean exit
            # or a hit too far.  64 occupancy probes across the box flag
            # rays whose first occupied cell lies well before the hit, or
            # that "exited" through occupied space: they re-render
            # volumetrically.  A hit's own dilation leads it by about
            # margin / cos(incidence) along the ray.
            t_near, t_far = march.ray_aabb_intersect(
                rays_o, rays_d, self.aabb_min, self.aabb_max)
            m = 64
            frac = (torch.arange(m, dtype=rays.dtype, device=rays.device)
                    + 0.5) / m
            span = torch.clamp(t_far - t_near, min=0.0)
            ts = t_near[:, None] + span[:, None] * frac[None]
            pts = rays_o[:, None] + rays_d[:, None] * ts[..., None]
            occ = march.occupancy_lookup(
                occ_binary, pts.reshape(-1, 3), self.aabb_min,
                self.aabb_max, self.grid_resolution).reshape(ts.shape)
            cell = 2.0 * self.radius / self.grid_resolution
            cos = torch.sum(rays_d * normal, -1).abs()
            margin = self.st_guard_margin * cell / torch.clamp(cos, 0.15,
                                                               1.0)
            limit = torch.where(hit, res.t_hit - margin, t_far + 1.0)
            suspect = (occ & (ts < limit[:, None])).any(-1)
            if self.st_sdf_clearance > 0:
                # half a marching step on top: the NeuS section estimator
                # reaches cos * step / 2 beyond each sample
                clear_miss = ~hit & (
                    (res.sdf_min - 0.5 * self.render_step_size)
                    * self.variance.inv_s(step) > self.st_sdf_clearance)
                suspect = suspect & ~clear_miss
            included = included & ~suspect
        w = hit.to(rays.dtype)[:, None]
        return {"res": res, "hit": hit, "w": w, "included": included,
                "pos": pos, "normal": normal, "geo": geo,
                "num_samples": hit.sum() * (self.st_iters + self.st_refine)}

    @torch.no_grad()
    def forward_surface(self, rays, *, occ_binary, mips, step,
                        stage: int = 1, relighting: bool = False,
                        background_color, levels=None, secondary_frac=None,
                        bake=None):
        """Sphere-traced eval (``eval_mode: sphere_trace``): the trace's
        hit shaded through the texture, split-sum and secondary pass of
        ``forward``, with ``forward``'s eval channels.  Rays the trace
        did not resolve, or that the guard flags, have ``ray_included``
        False (the system re-renders them volumetrically).
        ``num_samples`` counts ``iters + refine_iters`` probes per hit;
        ``stat_secondary_live`` rides along.  ``bake`` serves the
        secondary transmittance as in ``forward``; the trace reads the
        hash grid."""
        sr = self._surface_geometry(rays, occ_binary=occ_binary, step=step,
                                    levels=levels)
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        w, normal = sr["w"], sr["normal"]
        tex = self.texture.apply(sr["geo"]["feature"], rays_d, normal,
                                 sr["pos"], emitter=self.emitter, mips=mips,
                                 stage=stage, step=step)
        normal_map = normal * w
        depth_map = sr["res"].t_hit[:, None] * w
        maps = {"spec_rgb": tex["spec_rgb"] * w}
        if stage != 0:
            maps.update({k: tex[k] * w for k in (
                "spec_rgb_pbr", "spec_ref", "spec_light", "roughness")})
        sg = self._secondary_geom(
            rays_o, rays_d, occ_binary, step, levels=levels,
            secondary_frac=secondary_frac, normal_map=normal_map,
            depth_map=depth_map, acc_map=w, included=sr["included"],
            bake=bake, need_third=stage != 0 and relighting)
        maps = self._secondary_shade(sg, maps, stage=stage,
                                     relighting=relighting, mips=mips)

        def hit_map(k):
            return tex[k] * w if stage != 0 else None

        out = self._assemble_out(
            diff_rgb_map=tex["diff_rgb"] * w, maps=maps,
            blend_map=tex["blend"] * w, normal_map=normal_map,
            depth_map=depth_map, acc_map=w, num_samples=sr["num_samples"],
            included=sg["included"], inv_s=self.variance.inv_s(step),
            background_color=background_color, stage=stage,
            diff_rgb_pbr_map=hit_map("diff_rgb_pbr"),
            albedo_map=hit_map("albedo"), metallic_map=hit_map("metallic"))
        if self.indirect_pred:
            out["stat_secondary_live"] = sg["sec_live"]
        return out

    @torch.no_grad()
    def forward_surface_multi(self, rays, *, occ_binary, mips_list, step,
                              relight_flags, stage: int = 1,
                              background_color, levels=None,
                              secondary_frac=None, bake=None):
        """Multi-emitter sphere-traced eval: one trace, hit geometry,
        guard and secondary geometry, shaded under each of ``mips_list``
        (``forward_multi``'s contract); ``stat_secondary_live`` rides on
        output 0."""
        if len(mips_list) != len(relight_flags) or not mips_list:
            raise ValueError("one relight flag per mips, at least one")
        if not getattr(self.texture, "supports_multi_emitter", False):
            raise ValueError("the texture lacks the material_cache / "
                             "shade_cached split of a multi-emitter render")
        sr = self._surface_geometry(rays, occ_binary=occ_binary, step=step,
                                    levels=levels)
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        w, normal = sr["w"], sr["normal"]
        texc = self.texture.material_cache(
            sr["geo"]["feature"], rays_d, normal, sr["pos"], stage=stage,
            step=step)
        normal_map = normal * w
        depth_map = sr["res"].t_hit[:, None] * w
        hit_maps = {k: texc[k] * w for k in (
            ("diff_rgb", "spec_rgb", "blend") + (
                ("albedo", "metallic", "spec_ref", "roughness")
                if stage != 0 else ()))}
        sg = self._secondary_geom(
            rays_o, rays_d, occ_binary, step, levels=levels,
            secondary_frac=secondary_frac, normal_map=normal_map,
            depth_map=depth_map, acc_map=w, included=sr["included"],
            bake=bake, need_third=stage != 0 and any(relight_flags))

        outs = []
        for mips, relighting in zip(mips_list, relight_flags):
            maps = {"spec_rgb": hit_maps["spec_rgb"]}
            diff_rgb_pbr_map = None
            if stage != 0:
                shade = self.texture.shade_cached(texc, self.emitter, mips,
                                                  stage=stage)
                maps.update(spec_rgb_pbr=shade["spec_rgb_pbr"] * w,
                            spec_light=shade["spec_light"] * w,
                            spec_ref=hit_maps["spec_ref"],
                            roughness=hit_maps["roughness"])
                diff_rgb_pbr_map = shade["diff_rgb_pbr"] * w
            maps = self._secondary_shade(sg, maps, stage=stage,
                                         relighting=relighting, mips=mips)
            outs.append(self._assemble_out(
                diff_rgb_map=hit_maps["diff_rgb"], maps=maps,
                blend_map=hit_maps["blend"], normal_map=normal_map,
                depth_map=depth_map, acc_map=w,
                num_samples=sr["num_samples"], included=sg["included"],
                inv_s=self.variance.inv_s(step),
                background_color=background_color, stage=stage,
                diff_rgb_pbr_map=diff_rgb_pbr_map,
                albedo_map=hit_maps.get("albedo"),
                metallic_map=hit_maps.get("metallic")))
        if self.indirect_pred:
            outs[0]["stat_secondary_live"] = sg["sec_live"]
        return outs
