"""Split-occ system: the flagship's training and validation (counterpart
of ``rise_sdf_tpu/systems/split_occ.py``, single device).

Training adds to the NeuS step the stage flip (0: the radiance split; 1:
plus split-sum PBR at ``split_sum_kick_in_step``), the emitter mips built
inside the loss at stage 1 (so the base cubemap takes its gradient
through the prefilter's operators), the phys, curvature, normal
orientation and emitter distillation losses, and the background
composited in sRGB.  ``validate`` renders with the eval bake of the
checkpoint's step and the 2x/4x escalation; it reports PSNR, phys PSNR
(stage 1) and the rays dropped after escalation.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import register
from .criterions import psnr
from .neus import NeuSSystem
from ..utils.color import rgb_to_srgb


@register("split-occ-system")
class SplitOccSystem(NeuSSystem):
    def prepare(self):
        super().prepare()
        self.bg_srgb = True
        self._eval_bake = None  # (step, bake table)

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
    def eval_context(self, state) -> Dict:
        """The emitter mips and the checkpoint's eval bake (baked once per
        step, shared by the views of a validation)."""
        step = int(state["step"])
        if self._eval_bake is None or self._eval_bake[0] != step:
            self._eval_bake = (step, self.model.bake_eval_sdf(step))
        mips = self.model.emitter.build_mips() \
            if self.model.stage(step) != 0 else None
        return {"mips": mips, "bake": self._eval_bake[1]}

    def render_chunk(self, state, rays, mult: int = 1, mips=None,
                     bake=None):
        """One eval chunk with the model's eval options (banded marching
        into the band buffer); an escalation (``mult`` 2 or 4) takes
        ``mult`` times the full eval buffer and secondary budget.  Banded
        chunks skip the visibility compaction (the band is one)."""
        model = self.model
        step = int(state["step"])
        opts = model.eval_options(step, rays.shape[0])
        sec_frac = None
        if mult > 1:
            opts["capacity"] = self.eval_capacity * mult
            sec_frac = min(model.secondary_sample_capacity_frac * mult, 1.0)
        out = model(rays, occ_binary=state["occ_binary"], mips=mips,
                    step=step, bake=bake,
                    background_color=torch.ones(3, device=self.device),
                    secondary_frac=sec_frac,
                    vis_frac=1.0 if opts["banded"] else None, **opts)
        keep = ["comp_rgb_full", "comp_normal", "opacity", "depth",
                "ray_included"]
        if opts["stage"] != 0:
            keep.append("comp_rgb_phys_full")
        return {k: out[k] for k in keep}

    def validate(self, state, n_images: Optional[int] = None):
        split = self.datamodule.val()
        stage = self.model.stage(int(state["step"]))
        n = len(split) if n_images is None else min(n_images, len(split))
        psnrs, phys_psnrs, dropped = [], [], 0
        for i in range(n):
            out = self.render_image(state, split, i)
            gt = torch.from_numpy(split.all_images[i].reshape(-1, 3))
            mask = torch.from_numpy(split.all_fg_masks[i].reshape(-1, 1))
            gt = gt * mask + rgb_to_srgb(torch.ones(3)) * (1 - mask)
            psnrs.append(float(psnr(torch.from_numpy(out["comp_rgb_full"]),
                                    gt)))
            if stage != 0:
                phys_psnrs.append(float(psnr(
                    torch.from_numpy(out["comp_rgb_phys_full"]), gt)))
            dropped += int((~out["ray_included"]).sum())
        res = {"psnr": float(np.mean(psnrs)), "dropped_rays": dropped}
        if phys_psnrs:
            res["phys_psnr"] = float(np.mean(phys_psnrs))
        print(f"val: {res}", flush=True)
        return res
