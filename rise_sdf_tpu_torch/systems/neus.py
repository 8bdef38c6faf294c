"""NeuS system: geometry-only training and eval (counterpart of
``rise_sdf_tpu/systems/neus.py``, single device).

One train step: random ray batch on the device -> occupancy-pruned
march -> field and its gradient -> losses -> backward (the hash-table
gradient through kernel K1) -> finite-grads guard -> Adam and the LR
schedule.  The occupancy-grid EMA sweep runs every 16 steps.  Each step
takes the JAX fit's per-step flags: the open hash levels and the sample
buffer (``train_options``).  ``fit`` saves the whole training state
every ``trainer.save_every_n_steps`` steps (``latest.ckpt.npz``,
written in the background) and at its end, and validates one view every
``val_every`` steps; a run resumed from a checkpoint replays the
uninterrupted one.  ``test`` renders the test split and exports the
mesh (``export``), ``predict`` renders the predict split.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import register
from .base import BaseSystem
from .criterions import psnr
from ..export import export_mesh
from ..ops import grid as occ_grid
from ..utils.color import linear_to_srgb_np, rgb_to_srgb
from ..utils.misc import interleave_order
from ..utils.rays import get_rays


OCC_UPDATE_EVERY = 16  # steps between occupancy-grid sweeps in ``fit``


def _step_seed(seed: int, k: int) -> int:
    """Per-step generator seed: the random stream is a function of
    (seed, step), so a resumed run replays the batches of an
    uninterrupted one."""
    return (seed + 1) * 1_000_003 + k


@register("neus-system")
class NeuSSystem(BaseSystem):
    def prepare(self):
        mc = self.config["model"]
        self.train_num_rays = int(mc.get("max_train_num_rays",
                                         mc.get("train_num_rays", 4096)))
        default_cap = min(
            self.train_num_rays * int(mc["num_samples_per_ray"]), 1 << 20)
        if mc.get("dynamic_ray_sampling", False):
            # the sample budget of train_num_rays rays: the march drops
            # the rays of max_train_num_rays that do not fit
            default_cap = int(mc.get("train_num_rays", 256)) \
                * int(mc["num_samples_per_ray"])
        self.capacity = int(mc.get("train_sample_capacity", default_cap))
        # with the visibility prefilter on, the buffer holds only visible
        # samples, so a smaller one keeps every ray
        self.capacity_prefiltered = int(
            mc.get("train_sample_capacity_prefiltered", self.capacity))
        self.eval_chunk = int(mc.get("ray_chunk", 4096))
        self.eval_capacity = self.eval_chunk * int(
            mc.get("eval_samples_per_ray", 128))
        self.eval_ray_interleave = mc.get("eval_ray_interleave", False)
        self.grid_prune = bool(mc.get("grid_prune", True))
        self.background_color_mode = mc.get("background_color", "random")
        self.bg_srgb = False  # the split system composites bg in sRGB
        self.skipped_updates = 0

    # ------------------------------------------------------------------ #
    def init_state(self, seed: int = 42) -> Dict:
        """Fresh parameters drawn from ``seed``, a fresh optimizer and an
        all-occupied grid."""
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.fresh_optimizer()
        occs, binary = occ_grid.init_grid(self.model.grid_resolution,
                                          self.device)
        return {"step": 0, "occs": occs, "occ_binary": binary}

    def device_data(self, split) -> Dict[str, torch.Tensor]:
        dev = self.device
        return {
            "images": torch.as_tensor(split.all_images, device=dev),
            "masks": torch.as_tensor(split.all_fg_masks, device=dev),
            "c2w": torch.as_tensor(split.all_c2w, device=dev),
            "directions": torch.as_tensor(split.directions, device=dev),
        }

    # ------------------------------------------------------------------ #
    def sample_batch(self, generator, data, num_rays: Optional[int] = None):
        """Random (image, pixel) ray batch drawn on the device."""
        n_img, h, w = data["images"].shape[:3]
        r = num_rays or self.train_num_rays
        kw = {"generator": generator, "device": self.device}
        idx = torch.randint(0, n_img, (r,), **kw)
        x = torch.randint(0, w, (r,), **kw)
        y = torch.randint(0, h, (r,), **kw)
        rays_o, rays_d = get_rays(data["directions"][y, x], data["c2w"][idx])
        rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1,
                                                   keepdim=True)
        rgb = data["images"][idx, y, x]
        mask = data["masks"][idx, y, x]
        if self.background_color_mode == "white":
            bg = torch.ones(3, device=self.device)
        elif self.background_color_mode == "black":
            bg = torch.zeros(3, device=self.device)
        else:
            bg = torch.rand(3, **kw)
        bg_rgb = rgb_to_srgb(bg) if self.bg_srgb else bg
        rgb = rgb * mask[:, None] + bg_rgb[None, :] * (1 - mask[:, None])
        return {"rays": torch.cat([rays_o, rays_d], -1), "rgb": rgb,
                "mask": mask, "bg": bg}

    # ------------------------------------------------------------------ #
    def compute_losses(self, out, batch, step):
        cfg = self.config["system"]["loss"]
        lam_dist = cfg.get("lambda_distortion", 0.0)
        if isinstance(lam_dist, (list, tuple)) or lam_dist > 0:
            raise NotImplementedError("distortion loss is not ported yet")
        sel = out["rays_valid_full"][:, 0] & out["ray_included"]
        inc = out["ray_included"]
        sv = out["samples_valid"]

        losses = {}
        diff = out["comp_rgb_full"] - batch["rgb"]
        losses["rgb_mse"] = self.masked_mean(diff ** 2, sel)
        losses["rgb_l1"] = self.masked_mean(torch.abs(diff), sel)
        # safe norm: dead slots can have an exactly-zero gradient, and
        # sqrt'(0) = inf leaks NaN through the masked mean (0 * inf)
        grad_norm = torch.sqrt(
            torch.sum(out["sdf_grad_samples"] ** 2, dim=-1) + 1e-12)
        losses["eikonal"] = self.masked_mean((grad_norm - 1.0) ** 2, sv)
        opacity = torch.clamp(out["opacity"][:, 0], 1e-3, 1 - 1e-3)
        m = inc.float()
        n_inc = torch.clamp(m.sum(), min=1.0)
        losses["mask"] = -torch.sum(
            (batch["mask"] * torch.log(opacity)
             + (1 - batch["mask"]) * torch.log(1 - opacity)) * m) / n_inc
        losses["opaque"] = -torch.sum(
            (opacity * torch.log(opacity)
             + (1 - opacity) * torch.log(1 - opacity)) * m) / n_inc
        losses["sparsity"] = self.masked_mean(
            torch.exp(-float(cfg.get("sparsity_scale", 1.0))
                      * torch.abs(out["sdf_samples"])), sv)

        loss = (losses["rgb_mse"] * self.C(cfg["lambda_rgb_mse"], step)
                + losses["rgb_l1"] * self.C(cfg["lambda_rgb_l1"], step)
                + losses["eikonal"] * self.C(cfg["lambda_eikonal"], step)
                + losses["mask"] * self.C(cfg["lambda_mask"], step)
                + losses["opaque"] * self.C(cfg["lambda_opaque"], step)
                + losses["sparsity"] * self.C(cfg["lambda_sparsity"], step))
        return loss, losses

    def forward_loss(self, batch, occ_binary, step, generator=None,
                     capacity: Optional[int] = None, levels=None):
        """Model forward + loss assembly -> (loss, aux)."""
        out = self.model(batch["rays"], occ_binary=occ_binary, step=step,
                         generator=generator, train=True,
                         capacity=capacity or self.capacity,
                         background_color=batch["bg"], levels=levels)
        loss, losses = self.compute_losses(out, batch, step)
        aux = dict(losses)
        aux["inv_s"] = out["inv_s"]
        aux["num_samples"] = out["num_samples"]
        aux["num_rays"] = out["ray_included"].sum()
        return loss, aux

    def train_options(self, step: int) -> Dict:
        """``forward_loss``'s per-step options, as the JAX fit sets them:
        the open hash levels (the geometry takes hybrid finite
        differences only with an int count) and the sample buffer."""
        return {"levels": self.model.open_levels(step),
                "capacity": self.capacity}

    def train_step(self, state, batch, generator=None, **kw) -> Dict:
        """One update on ``batch``; advances ``state["step"]``.  ``kw``
        goes on to ``forward_loss`` (the curvature probe's
        ``laplace_dirs``).

        A parameter off this step's graph (the emitter and the roughness
        head before the split-sum stage) takes a zero gradient, so that
        Adam advances its moments and its step count as optax does for
        every leaf.  Finite-grads guard: a non-finite gradient anywhere
        skips the optimizer step and the LR-schedule step together (the
        JAX step keeps the whole optax state, schedule count included)
        and counts the skip in ``self.skipped_updates``."""
        step = int(state["step"])
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.forward_loss(batch, state["occ_binary"], step,
                                      generator, **self.train_options(step),
                                      **kw)
        loss.backward()
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        ok = bool(torch.stack([torch.isfinite(p.grad).all()
                               for p in params]).all())
        if ok:
            self.optimizer.step()
            self.scheduler.step()
        else:
            self.skipped_updates += 1
        self.model.post_update(step)
        aux["loss"] = loss.detach()
        aux["skipped_nonfinite"] = 0.0 if ok else 1.0
        state["step"] = step + 1
        return aux

    # ------------------------------------------------------------------ #
    def fit(self, max_steps: Optional[int] = None, seed: int = 42,
            state=None, log_every: int = 100,
            val_every: Optional[int] = None, on_log=None):
        """Training loop from ``state`` (a fresh one from ``seed`` when
        None) to ``max_steps`` (``trainer.max_steps``).  After each step
        whose index is a positive multiple of ``trainer.save_every_n_steps``
        the state goes to ``ckpt_dir/latest.ckpt.npz`` asynchronously,
        and after each positive multiple of ``val_every`` one view is
        validated; at the end, after the writer is joined, the state
        goes to ``ckpt_dir/step_N.ckpt.npz``.  ``on_log(step, metrics)``
        replaces the printed log line; metrics are host floats, with
        ``steps_per_sec`` since the start and ``steps_per_sec_window``
        since the previous log line."""
        cfg_tr = self.config["trainer"]
        max_steps = max_steps or int(cfg_tr["max_steps"])
        save_every = int(cfg_tr.get("save_every_n_steps", 0) or 0)
        val_every = int(val_every or 0)
        if state is None:
            state = self.init_state(seed)
        elif self.optimizer is None:
            self.fresh_optimizer()
        data = self.device_data(self.datamodule.train())
        gen = torch.Generator(device=self.device)
        t0 = time.time()
        start = int(state["step"])
        mark = (start, t0)  # the step and time of the last log line
        for step in range(start, max_steps):
            if self.grid_prune and step % OCC_UPDATE_EVERY == 0:
                gen.manual_seed(_step_seed(seed, 2 * step + 1))
                self.update_occupancy(state, gen)
            gen.manual_seed(_step_seed(seed, 2 * step))
            batch = self.sample_batch(gen, data)
            aux = self.train_step(state, batch, gen)
            if log_every and (step % log_every == 0 or step == max_steps - 1):
                mark = self._log(step, start, t0, mark, aux, on_log)
            if save_every and step > 0 and step % save_every == 0:
                self.save_checkpoint(state, os.path.join(
                    self.ckpt_dir, "latest.ckpt.npz"), async_write=True)
            if val_every and step > 0 and step % val_every == 0:
                self.validate(state, n_images=1)
        self.save_checkpoint(state)
        return state

    def _log(self, step, start, t0, mark, aux, on_log):
        """One log line (or ``on_log``); returns the new rate mark."""
        vals = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                            device=self.device)
                            for v in aux.values()]).tolist()
        m = dict(zip(aux.keys(), vals))
        now = time.time()
        m["steps_per_sec"] = (step - start + 1) / (now - t0)
        last_step, last_t = mark
        m["steps_per_sec_window"] = (step - last_step) \
            / max(now - last_t, 1e-9) if step > last_step else 0.0
        if m["skipped_nonfinite"] > 0:
            print(f"WARNING: step {step}: non-finite grads — "
                  "update skipped", flush=True)
        if on_log:
            on_log(step, m)
        else:
            phys = (f" phys={m['rgb_phys_mse']:.5f}"
                    if "rgb_phys_mse" in m else "")
            print(f"step {step}: loss={m['loss']:.4f} "
                  f"mse={m['rgb_mse']:.5f}{phys} "
                  f"inv_s={m['inv_s']:.1f} "
                  f"rays={int(m['num_rays'])} "
                  f"samples={int(m['num_samples'])} "
                  f"sps={m['steps_per_sec']:.2f} "
                  f"w={m['steps_per_sec_window']:.3f}", flush=True)
        return step, now

    # ------------------------------------------------------------------ #
    def eval_context(self, state, emitter_base=None) -> Dict:
        """Per-image inputs of ``render_chunk`` beyond the rays."""
        return {}

    def render_chunk(self, state, rays, mult: int = 1):
        """One eval chunk into a buffer of ``mult`` times the eval
        capacity."""
        out = self.model(rays, occ_binary=state["occ_binary"],
                         step=int(state["step"]), train=False,
                         capacity=self.eval_capacity * mult,
                         background_color=torch.ones(3, device=self.device))
        keep = ["comp_rgb_full", "comp_normal", "opacity", "depth",
                "ray_included"]
        return {k: out[k] for k in keep}

    def view_rays(self, split, index: int):
        """View ``index``'s unit rays [H * W, 6] on the device, in the
        configured eval interleave, and the inverse permutation (None
        when the rays keep their order)."""
        dirs = torch.as_tensor(split.directions, device=self.device)
        c2w = torch.as_tensor(split.all_c2w[index], device=self.device)
        rays_o, rays_d = get_rays(dirs, c2w)
        rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1,
                                                   keepdim=True)
        rays = torch.cat([rays_o, rays_d], -1)
        order, inv = interleave_order(rays.shape[0], self.eval_chunk,
                                      self.eval_ray_interleave)
        if order is None:
            return rays, None
        return rays[torch.from_numpy(order).to(self.device)], \
            torch.from_numpy(inv).to(self.device)

    @torch.no_grad()
    def render_image(self, state, split, index: int, emitter_base=None,
                     **opts) -> Dict[str, np.ndarray]:
        """Serial chunk loop over one view, in the configured ray
        interleave.  A chunk whose rays overflow the fixed sample buffer
        is rendered again with a 2x, then 4x buffer, with the same
        ``opts`` (so a multi-emitter chunk keeps its lights);
        ``ray_included`` says which rays fit in the end.
        ``emitter_base`` and ``opts`` go to ``eval_context`` and
        ``render_chunk``; the chunks' ``stat_*`` counts are dropped."""
        rays, inv = self.view_rays(split, index)
        n, chunk = rays.shape[0], self.eval_chunk
        outs = []
        with self.frozen_params():
            ctx = self.eval_context(state, emitter_base)
            for s in range(0, n, chunk):
                part = rays[s:s + chunk]
                pad = chunk - part.shape[0]
                if pad:
                    # edge-pad: duplicated real rays behave like their
                    # source (zero-direction rays would overflow the buffer)
                    part = torch.cat([part, part[-1:].expand(pad, -1)])
                res = self.render_chunk(state, part, **ctx, **opts)
                for mult in (2, 4):
                    if bool(res["ray_included"].all()):
                        break
                    res = self.render_chunk(state, part, mult, **ctx, **opts)
                dropped = int((~res["ray_included"]).sum())
                if dropped:
                    print(f"WARNING: eval chunk at ray {s}: {dropped} rays "
                          "overflowed the 4x sample buffer and were rendered "
                          "partially — metrics may be corrupted", flush=True)
                outs.append({k: v[:chunk - pad] for k, v in res.items()
                             if not k.startswith("stat_")})
        img = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        if inv is not None:
            img = {k: v[inv] for k, v in img.items()}
        return {k: v.cpu().numpy() for k, v in img.items()}

    def validate(self, state, n_images: Optional[int] = None):
        split = self.datamodule.val()
        n = len(split) if n_images is None else min(n_images, len(split))
        psnrs = []
        for i in range(n):
            out = self.render_image(state, split, i)
            gt = split.all_images[i].reshape(-1, 3)
            mask = split.all_fg_masks[i].reshape(-1, 1)
            gt = gt * mask + 1.0 * (1 - mask)
            psnrs.append(float(psnr(torch.from_numpy(out["comp_rgb_full"]),
                                    torch.from_numpy(gt))))
        mean_psnr = float(np.mean(psnrs))
        print(f"val/psnr = {mean_psnr:.3f}", flush=True)
        return {"psnr": mean_psnr}

    # ------------------------------------------------------------------ #
    def _save_test_view(self, name, gt, out, h, w):
        """Ground truth, render, depth and normals side by side."""
        self.saver.save_image_grid(name, [
            {"type": "rgb", "img": gt.reshape(h, w, 3),
             "kwargs": {"data_format": "HWC"}},
            {"type": "rgb", "img": out["comp_rgb_full"].reshape(h, w, 3),
             "kwargs": {"data_format": "HWC"}},
            {"type": "grayscale", "img": out["depth"].reshape(h, w),
             "kwargs": {}},
            {"type": "rgb", "img": out["comp_normal"].reshape(h, w, 3),
             "kwargs": {"data_format": "HWC", "data_range": (-1, 1)}}])

    def test(self, state, export: bool = True) -> Dict[str, float]:
        """Render every test view, save its grid under ``it{step}-test/``
        and return the mean PSNR; then, with ``export``, the mesh."""
        split = self.datamodule.test()
        step = int(state["step"])
        psnrs = []
        for i in range(len(split)):
            print(f"test view {i + 1}/{len(split)}", flush=True)
            out = self.render_image(state, split, i)
            gt = split.all_images[i].reshape(-1, 3)
            mask = split.all_fg_masks[i].reshape(-1, 1)
            gt = gt * mask + 1.0 * (1 - mask)
            psnrs.append(float(psnr(torch.from_numpy(out["comp_rgb_full"]),
                                    torch.from_numpy(gt))))
            self._save_test_view(f"it{step}-test/{i}.png", gt, out,
                                 split.h, split.w)
        res = {"psnr": float(np.mean(psnrs))}
        print(f"test/psnr = {res['psnr']:.3f}", flush=True)
        if export:
            self.export(state)
        return res

    def predict(self, state, hdr_filepath=None):
        """Render every view of the predict split (the test split when
        the dataset has none) into ``it{step}-predict/``."""
        dm = self.datamodule
        split = dm.predict() if hasattr(dm, "predict") else dm.test()
        step = int(state["step"])
        for i in range(len(split)):
            out = self.render_image(state, split, i)
            self.saver.save_image_grid(f"it{step}-predict/{i}.png", [
                {"type": "rgb",
                 "img": out["comp_rgb_full"].reshape(split.h, split.w, 3),
                 "kwargs": {"data_format": "HWC"}}])

    def export(self, state, times: Optional[Dict[str, float]] = None):
        """The mesh of ``export_mesh`` as ``it{step}-{method}{res}.ply``
        with vertex colours, and for the PBR model ``albedo.npy``,
        ``metallic.npy`` and ``roughness.npy`` (sRGB-encoded, as the
        JAX package writes them); returns the mesh (None without a
        surface).  ``times`` gets ``export_mesh``'s seconds."""
        with self.frozen_params():
            mesh = export_mesh(self.model, state, self.config, times)
        if mesh is None:
            return None
        iso = self.config["model"]["geometry"]["isosurface"]
        self.saver.save_mesh(
            f"it{int(state['step'])}-{iso['method']}{iso['resolution']}.ply",
            mesh["v_pos"], mesh["t_pos_idx"], mesh.get("v_rgb"))
        for k in ("albedo", "metallic", "roughness"):
            if k in mesh:
                self.saver.save_npy(f"{k}.npy", linear_to_srgb_np(mesh[k]))
        return mesh
