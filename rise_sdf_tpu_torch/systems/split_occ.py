"""Split-occ system: the flagship's training and validation (counterpart
of ``rise_sdf_tpu/systems/split_occ.py``, single device).

Training adds to the NeuS step the stage flip (0: the radiance split; 1:
plus split-sum PBR at ``split_sum_kick_in_step``), the emitter mips built
inside the loss at stage 1 (so the base cubemap takes its gradient
through the prefilter's operators), the phys, curvature, normal
orientation and emitter distillation losses, and the background
composited in sRGB.  ``validate`` renders with the eval bake of the
checkpoint's step and the 2x/4x escalation; it reports PSNR, phys PSNR
(stage 1) and the rays dropped after escalation, and saves image grids.

``test`` is the evaluation protocol: with ``derive_compaction`` the eval
compaction fractions come from ``calibrate_eval``; every test view is
rendered under the learned light and under each light of the dataset's
``relight_list`` (the third mirror bounce on), in one geometry pass per
chunk (``forward_multi``) unless ``system.multi_emitter_eval`` is false;
it reports novel-view PSNR, phys PSNR and SSIM, median-aligned albedo
PSNR and SSIM and roughness PSNR, the normals' mean angular error, and
per light the relight PSNR and SSIM.  There is no LPIPS (its weights are
a download).  Then, by default, ``export`` writes the mesh with its
baked albedo, metallic and roughness (``NeuSSystem.export``).
``predict`` renders every test view under one environment file.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import register
from .criterions import mean_angular_error, psnr, ssim
from .neus import NeuSSystem
from ..utils.color import linear_to_srgb_np

# the chunk's per-ray outputs that an eval keeps (the calibration
# statistics ride along and are dropped by ``render_image``)
_KEEP = ("comp_rgb_full", "comp_normal", "opacity", "depth", "comp_blend",
         "comp_diffuse_rgb", "comp_spec_rgb", "ray_included", "stat_live",
         "stat_vis", "stat_secondary_live", "comp_rgb_phys_full",
         "comp_albedo", "comp_metallic", "comp_roughness",
         "comp_spec_rgb_phys", "comp_diffuse_rgb_phys")


def _rgb(img, h, w, **kwargs):
    return {"type": "rgb", "img": img.reshape(h, w, 3),
            "kwargs": {"data_format": "HWC", **kwargs}}


def _gray(img, h, w, **kwargs):
    return {"type": "grayscale", "img": img.reshape(h, w), "kwargs": kwargs}


@register("split-occ-system")
class SplitOccSystem(NeuSSystem):
    def prepare(self):
        super().prepare()
        self.bg_srgb = True
        self._eval_bake = None  # (step, bake table)
        self.relight_list = list(
            self.config["dataset"].get("relight_list", []) or [])
        # the fractions the last ``test`` rendered with (empty: the
        # model's own)
        self.eval_fractions = {}

    def train_prefilter(self, step: int) -> bool:
        """Is the visibility prefilter on at training ``step``?"""
        return self.model.prefilter_on(step, train=True)

    def train_options(self, step: int) -> Dict:
        """The NeuS step's options plus the prefilter flag; the buffer
        holds only visible samples while the prefilter is on."""
        pf = self.train_prefilter(step)
        opts = super().train_options(step)
        opts["prefilter"] = pf
        if pf:
            opts["capacity"] = self.capacity_prefiltered
        return opts

    # ------------------------------------------------------------------ #
    def compute_losses(self, out, batch, step, stage: int = 0):
        cfg = self.config["system"]["loss"]
        loss, losses = super().compute_losses(out, batch, step)
        sel = out["rays_valid_full"][:, 0] & out["ray_included"]
        inc = out["ray_included"]

        if stage != 0:
            diff = out["comp_rgb_phys_full"] - batch["rgb"]
            losses["rgb_phys_mse"] = self.masked_mean(diff ** 2, sel)
            losses["rgb_phys_l1"] = self.masked_mean(torch.abs(diff), sel)
            loss = loss \
                + losses["rgb_phys_mse"] \
                * self.C(cfg["lambda_rgb_phys_mse"], step) \
                + losses["rgb_phys_l1"] * self.C(cfg["lambda_rgb_phys_l1"],
                                                 step)
            lam_distill = cfg.get("lambda_emitter_distillation", 0.0)
            if not isinstance(lam_distill, (int, float)) or lam_distill > 0:
                d = out["comp_spec_rgb_full"] - out["comp_spec_rgb_phys_full"]
                losses["emitter_distillation"] = self.masked_mean(d ** 2, sel)
                loss = loss + losses["emitter_distillation"] \
                    * self.C(lam_distill, step)

        lam_curv = cfg.get("lambda_curvature", 0.0)
        if "sdf_laplace_samples" in out and (
                not isinstance(lam_curv, (int, float)) or lam_curv > 0):
            losses["curvature"] = self.masked_mean(
                torch.abs(out["sdf_laplace_samples"]),
                out["sdf_laplace_valid"])
            loss = loss + losses["curvature"] * self.C(lam_curv, step)

        lam_no = cfg.get("lambda_normal_orientation", 0.0)
        losses["normal_orientation"] = self.masked_mean(
            out["normals_orientation_loss_map"], inc)
        loss = loss + losses["normal_orientation"] * self.C(lam_no, step)
        return loss, losses

    def forward_loss(self, batch, occ_binary, step, generator=None,
                     capacity: Optional[int] = None, levels=None,
                     prefilter: bool = False, laplace_dirs=None):
        """Model forward + loss assembly -> (loss, aux).  The stage follows
        from ``step``; ``laplace_dirs`` fixes the curvature probe's draws
        (else they come from ``generator``)."""
        stage = self.model.stage(step)
        mips = self.model.emitter.build_mips() if stage != 0 else None
        out = self.model(batch["rays"], occ_binary=occ_binary, mips=mips,
                         step=step, stage=stage, train=True,
                         capacity=capacity or self.capacity,
                         background_color=batch["bg"], levels=levels,
                         prefilter=prefilter, generator=generator,
                         laplace_dirs=laplace_dirs)
        loss, losses = self.compute_losses(out, batch, step, stage)
        aux = dict(losses)
        aux["inv_s"] = out["inv_s"]
        aux["num_samples"] = out["num_samples"]
        aux["num_rays"] = out["ray_included"].sum()
        return loss, aux

    # ------------------------------------------------------------------ #
    def eval_context(self, state, emitter_base=None) -> Dict:
        """The checkpoint's eval bake (baked once per step, shared by the
        views and lights of an eval) and, at stage 1, the mips of the
        learned light, of ``emitter_base`` [6, R, R, 3], or of each base
        of a list (a multi-emitter render)."""
        step = int(state["step"])
        if self._eval_bake is None or self._eval_bake[0] != step:
            self._eval_bake = (step, self.model.bake_eval_sdf(step))
        build = self.model.emitter.build_mips
        if self.model.stage(step) == 0:
            mips = None
        elif isinstance(emitter_base, (list, tuple)):
            mips = [build(b) for b in emitter_base]
        else:
            mips = build(emitter_base)
        return {"mips": mips, "bake": self._eval_bake[1]}

    def render_chunk(self, state, rays, mult: int = 1, mips=None,
                     bake=None, relighting: bool = False,
                     n_relights: int = 0, capacity: Optional[int] = None,
                     secondary_frac=None, vis_frac=None):
        """One eval chunk with the model's eval options (banded marching
        into the band buffer).  ``capacity`` and the fractions override
        the model's (the calibration probe, the calibrated fractions); an
        escalation (``mult`` 2 or 4) takes ``mult`` times the full eval
        buffer and ``mult`` times the secondary fraction.  Banded chunks
        skip the visibility compaction (the band is one).  With
        ``n_relights`` the chunk renders ``mips`` = [learned light, relight
        lights...] in one geometry pass and returns the learned light's
        channels plus ``relight{j}/comp_rgb_phys_full``."""
        model = self.model
        step = int(state["step"])
        opts = model.eval_options(step, rays.shape[0])
        if mult > 1:
            capacity = self.eval_capacity * mult
            base = model.secondary_sample_capacity_frac \
                if secondary_frac is None else secondary_frac
            secondary_frac = min(base * mult, 1.0)
        if capacity is not None:
            opts["capacity"] = capacity
        kw = dict(occ_binary=state["occ_binary"], step=step, bake=bake,
                  background_color=torch.ones(3, device=self.device),
                  secondary_frac=secondary_frac,
                  vis_frac=1.0 if opts["banded"] else vis_frac, **opts)
        if not n_relights:
            out = model(rays, mips=mips, relighting=relighting, **kw)
            return {k: out[k] for k in _KEEP if k in out}
        if opts["stage"] == 0 or len(mips) != 1 + n_relights:
            raise ValueError("a multi-emitter chunk renders at stage 1 and "
                             "takes the learned light's and n_relights "
                             "mips")
        outs = model.forward_multi(
            rays, mips_list=mips,
            relight_flags=(False,) + (True,) * n_relights, **kw)
        res = {k: outs[0][k] for k in _KEEP if k in outs[0]}
        for j, o in enumerate(outs[1:]):
            res[f"relight{j}/comp_rgb_phys_full"] = o["comp_rgb_phys_full"]
        return res

    # ------------------------------------------------------------------ #
    def _gt(self, split, i):
        """View ``i``'s ground truth [H * W, 3] on the white background
        (composited in sRGB) and its mask [H * W, 1], on the host."""
        mask = split.all_fg_masks[i].reshape(-1, 1)
        gt = split.all_images[i].reshape(-1, 3) * mask \
            + linear_to_srgb_np(np.ones(3))[None] * (1 - mask)
        return gt, mask

    def _dev(self, a):
        """A host array as a float32 tensor on the device (the metrics'
        inputs)."""
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    def _save_envmap(self, state):
        img = self.model.emitter.generate_image().cpu().numpy()
        self.saver.save_image_grid(f"it{int(state['step'])}-envmap.exr", [
            {"type": "hdr", "img": img, "kwargs": {"data_format": "HWC"}}])

    def _save_view(self, name, gt, out, h, w):
        """The view's grid: ground truth, the render, blend, specular,
        diffuse, depth and normals."""
        self.saver.save_image_grid(name, [
            _rgb(gt, h, w), _rgb(out["comp_rgb_full"], h, w),
            _gray(out["comp_blend"], h, w, data_range=None, cmap=None),
            _rgb(out["comp_spec_rgb"], h, w),
            _rgb(out["comp_diffuse_rgb"], h, w),
            _gray(out["depth"], h, w),
            _rgb(out["comp_normal"], h, w, data_range=(-1, 1))])

    def validate(self, state, n_images: Optional[int] = None):
        split = self.datamodule.val()
        step = int(state["step"])
        stage = self.model.stage(step)
        self._save_envmap(state)
        n = len(split) if n_images is None else min(n_images, len(split))
        h, w = split.h, split.w
        psnrs, phys_psnrs, dropped = [], [], 0
        for i in range(n):
            out = self.render_image(state, split, i)
            gt, _ = self._gt(split, i)
            psnrs.append(float(psnr(self._dev(out["comp_rgb_full"]),
                                    self._dev(gt))))
            self._save_view(f"it{step}-{i}.png", gt, out, h, w)
            if stage != 0:
                phys_psnrs.append(float(psnr(
                    self._dev(out["comp_rgb_phys_full"]), self._dev(gt))))
                self.saver.save_image_grid(f"it{step}-{i}-pbr.png", [
                    _rgb(gt, h, w), _rgb(out["comp_rgb_phys_full"], h, w),
                    _rgb(out["comp_albedo"], h, w),
                    _gray(out["comp_metallic"], h, w, data_range=None,
                          cmap=None),
                    _gray(out["comp_roughness"], h, w, data_range=None,
                          cmap=None)])
            dropped += int((~out["ray_included"]).sum())
        res = {"psnr": float(np.mean(psnrs)), "dropped_rays": dropped}
        if phys_psnrs:
            res["phys_psnr"] = float(np.mean(phys_psnrs))
        print(f"val: {res}", flush=True)
        return res

    # ------------------------------------------------------------------ #
    @staticmethod
    def _median_align(pred, gt, mask):
        """Per-channel median-ratio alignment of ``pred`` to ``gt`` over
        the mask, clipped to [0, 1] (on the host, in numpy)."""
        m = mask.astype(bool).reshape(-1)
        if m.sum() == 0:
            return pred
        ratio = np.median(gt.reshape(-1, gt.shape[-1])[m]
                          / np.clip(pred.reshape(-1, pred.shape[-1])[m],
                                    1e-6, None), axis=0)
        out = pred.copy().reshape(-1, pred.shape[-1])
        out[m] = np.clip(ratio * out[m], 0.0, 1.0)
        return out.reshape(pred.shape)

    def calibrate_eval(self, state, split, n_chunks: int = 2) -> Dict:
        """The eval compaction fractions from measured statistics: two
        central chunks of view 0, in the eval ray order (the chunk
        composition eval renders), at twice the eval capacity with
        fractions 1.0; each fraction is 1.25 x the chunks' largest count
        over its buffer, snapped up to 1/16, at least 1/16."""
        rays, _ = self.view_rays(split, 0)
        n, chunk = rays.shape[0], self.eval_chunk
        mid = n // 2  # the central rows see the object densest
        vis_max = sec_max = 0
        with torch.no_grad(), self.frozen_params():
            ctx = self.eval_context(state)
            for k in range(n_chunks):
                s = mid - (k + 1) * chunk // 2 * (1 if k % 2 else -1)
                s = int(np.clip(s, 0, max(n - chunk, 0)))
                res = self.render_chunk(
                    state, rays[s:s + chunk],
                    capacity=self.eval_capacity * 2, secondary_frac=1.0,
                    vis_frac=1.0, **ctx)
                vis_max = max(vis_max, int(res.get("stat_vis", 0)))
                sec_max = max(sec_max,
                              int(res.get("stat_secondary_live", 0)))

        def snap(frac):
            return min(np.ceil(frac * 16.0) / 16.0, 1.0)

        vis_frac = snap(1.25 * vis_max / max(self.eval_capacity, 1))
        s2 = chunk * self.model.num_samples_per_secondary_ray
        sec_frac = snap(1.25 * sec_max / max(s2, 1))
        print(f"calibrated eval compaction: vis_frac={vis_frac:.3f} "
              f"(max {vis_max} vis samples), secondary_frac={sec_frac:.3f} "
              f"(max {sec_max} live)", flush=True)
        return {"vis_frac": float(max(vis_frac, 1.0 / 16.0)),
                "secondary_frac": float(max(sec_frac, 1.0 / 16.0))}

    def view_metrics(self, split, i: int, out) -> Dict[str, float]:
        """The protocol's metrics of test view ``i`` from its render
        ``out`` (stage 1), which holds ``relight{j}/comp_rgb_phys_full``
        for each light of ``relight_list``: PSNR, phys PSNR and SSIM,
        median-aligned albedo PSNR and SSIM and roughness PSNR, the
        normals' mean angular error in degrees over the foreground, and
        per light the median-aligned relight PSNR and SSIM.  The median
        alignment runs on the host; the metrics on the device."""
        h, w = split.h, split.w
        gt, mask = self._gt(split, i)
        phys = out["comp_rgb_phys_full"]
        res = {"psnr": psnr(self._dev(out["comp_rgb_full"]), self._dev(gt)),
               "phys_psnr": psnr(self._dev(phys), self._dev(gt)),
               "phys_ssim": ssim(self._dev(phys.reshape(h, w, 3)),
                                 self._dev(gt.reshape(h, w, 3)))}
        ds = self.config["dataset"]
        if ds.get("has_albedo", False):
            gt_alb = split.all_albedo[i].reshape(-1, 3)
            alb = self._median_align(out["comp_albedo"], gt_alb, mask)
            res["albedo_psnr"] = psnr(self._dev(alb), self._dev(gt_alb))
            res["albedo_ssim"] = ssim(self._dev(alb.reshape(h, w, 3)),
                                      self._dev(gt_alb.reshape(h, w, 3)))
        if ds.get("has_roughness", False):
            gt_r = split.all_roughness[i].reshape(-1, 1)
            r = self._median_align(out["comp_roughness"], gt_r, mask)
            res["roughness_psnr"] = psnr(self._dev(r), self._dev(gt_r))
        res["normal_mae"] = mean_angular_error(
            self._dev(out["comp_normal"].reshape(-1, 3)),
            self._dev(split.all_normals[i].reshape(-1, 3)),
            mask=self._dev(mask), degrees=True)
        for j, light in enumerate(self.relight_list):
            gt_rel = split.relight_images[light][i].reshape(-1, 3) * mask \
                + linear_to_srgb_np(np.ones(3))[None] * (1 - mask)
            pred = self._median_align(out[f"relight{j}/comp_rgb_phys_full"],
                                      gt_rel, mask)
            res[f"relight_psnr_{light}"] = psnr(self._dev(pred),
                                                self._dev(gt_rel))
            res[f"relight_ssim_{light}"] = ssim(
                self._dev(pred.reshape(h, w, 3)),
                self._dev(gt_rel.reshape(h, w, 3)))
        return {k: float(v) for k, v in res.items()}

    def test(self, state, export: bool = True) -> Dict[str, float]:
        """The evaluation protocol over the test split (module
        docstring); returns the mean of each metric over the views and
        ``dropped_rays``, the rays left out after escalation in every
        render; then, with ``export``, the mesh and its materials
        (``export``)."""
        split = self.datamodule.test()
        step = int(state["step"])
        stage = self.model.stage(step)
        fr = {}
        if self.config["model"].get("derive_compaction", False):
            fr = self.calibrate_eval(state, split)
        self.eval_fractions = fr
        lights = self.relight_list
        multi = stage != 0 and bool(lights) and bool(
            self.config["system"].get("multi_emitter_eval", True))
        self._save_envmap(state)
        bases = [self.model.emitter.relight_params(os.path.join(
            self.config["dataset"]["hdr_filepath"], f"{l}.exr"))["base"]
            for l in lights]
        metrics, dropped = [], 0
        h, w = split.h, split.w
        t0 = time.time()
        for i in range(len(split)):
            print(f"test view {i + 1}/{len(split)}", flush=True)
            if multi:
                out = self.render_image(state, split, i,
                                        emitter_base=[None] + bases,
                                        n_relights=len(lights), **fr)
            else:
                out = self.render_image(state, split, i, **fr)
            dropped += int((~out["ray_included"]).sum())
            gt, _ = self._gt(split, i)
            self._save_view(f"it{step}-test/{i}.png", gt, out, h, w)
            if stage == 0:
                metrics.append({"psnr": float(psnr(
                    self._dev(out["comp_rgb_full"]), self._dev(gt)))})
                continue
            for j, base in enumerate(bases if not multi else []):
                rout = self.render_image(state, split, i, emitter_base=base,
                                         relighting=True, **fr)
                dropped += int((~rout["ray_included"]).sum())
                out[f"relight{j}/comp_rgb_phys_full"] = \
                    rout["comp_rgb_phys_full"]
            metrics.append(self.view_metrics(split, i, out))
            self._save_pbr_grids(step, split, i, gt, out)

        res = {k: float(np.mean([m[k] for m in metrics]))
               for k in metrics[0]}
        dt = time.time() - t0
        n_renders = len(split) * (1 if multi or stage == 0
                                  else 1 + len(lights))
        mode = "multi-emitter geometry passes" if multi else "full renders"
        print(f"test protocol wall time: {dt:.1f}s for {len(split)} views "
              f"({dt / max(len(split), 1):.1f} s/view, {n_renders} {mode} "
              f"incl. metrics/IO)", flush=True)
        res["dropped_rays"] = dropped
        print(f"test: {res}", flush=True)
        if export:
            self.export(state)
        return res

    def _save_pbr_grids(self, step, split, i, gt, out):
        """View ``i``'s physically based grid, its median-aligned albedo
        against the ground truth, and each relight image against its
        ground truth."""
        h, w = split.h, split.w
        _, mask = self._gt(split, i)
        self.saver.save_image_grid(f"it{step}-test/{i}-pbr.png", [
            _rgb(gt, h, w), _rgb(out["comp_rgb_phys_full"], h, w),
            _rgb(out["comp_albedo"], h, w),
            _gray(out["comp_metallic"], h, w, data_range=None, cmap=None),
            _gray(out["comp_roughness"], h, w, data_range=None, cmap=None),
            _rgb(out["comp_spec_rgb_phys"], h, w),
            _rgb(out["comp_diffuse_rgb_phys"], h, w)])
        if self.config["dataset"].get("has_albedo", False):
            gt_alb = split.all_albedo[i].reshape(-1, 3)
            alb = self._median_align(out["comp_albedo"], gt_alb, mask)
            self.saver.save_image_grid(f"it{step}-test/{i}-albedo.png",
                                       [_rgb(gt_alb, h, w), _rgb(alb, h, w)])
        for j, light in enumerate(self.relight_list):
            gt_rel = split.relight_images[light][i].reshape(-1, 3) * mask \
                + linear_to_srgb_np(np.ones(3))[None] * (1 - mask)
            self.saver.save_image_grid(
                f"it{step}-test/{i}-relight-{light}.png",
                [_rgb(gt_rel, h, w),
                 _rgb(out[f"relight{j}/comp_rgb_phys_full"], h, w)])

    def predict(self, state, hdr_filepath: str):
        """Render every test view under the environment file
        ``hdr_filepath`` (the relighting path, third bounce on) and save
        the images."""
        split = self.datamodule.test()
        base = self.model.emitter.relight_params(hdr_filepath)["base"]
        step = int(state["step"])
        name = os.path.splitext(os.path.basename(hdr_filepath))[0]
        for i in range(len(split)):
            out = self.render_image(state, split, i, emitter_base=base,
                                    relighting=True)
            self.saver.save_image_grid(
                f"it{step}-predict-{name}/{i}.png",
                [_rgb(out["comp_rgb_phys_full"], split.h, split.w)])
