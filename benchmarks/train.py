"""Training traffic: the per-step sequence of the program's ``fit``
(an occupancy sweep every ``occupancy_every`` steps, then
``sample_batch`` and ``train_step``), driven from the harness's own
loop so that it can stop at a deadline.

Set-up builds one training system with the weights drawn from the seed,
runs its first ``compared_steps`` steps through the window's own calls
and records what ``correct`` compares (each step's loss, the first
gradient as Adam holds it, the parameters' change), then runs warm
steps up to ``start_step + warm_steps``.  The window runs whole steps
until ``seconds`` have passed and ends synchronised: steps/s is the
steps completed over the window's wall time, sweeps included.  Once the
window is closed and the program freed, the reference replays the
compared steps from the same weights, batches and draws.

With ``trace``, the window times its occupancy sweeps synchronised and
counts the live samples of every step; after it one sweep period is
profiled for the device's busy share and the breakdown, and the next
one with the host's operations and the kernels' launches recorded.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from . import common
from .yardstick import compare, flops, launches


def _leaf_names(model) -> Dict[int, str]:
    named = dict(model.named_parameters())
    named.update(dict(model.named_buffers()))
    return {id(t): n for n, t in named.items()}


def _optimizer_leaves(system):
    names = _leaf_names(system.model)
    return [(names[id(p)], p, g) for g in system.optimizer.param_groups
            for p in g["params"]]


class Trainer:
    """One training system and its state, stepped as ``fit`` steps it."""

    def __init__(self, systems, cfg, datamodule, weights, seed, device,
                 start_step, occupancy_every, init_grid,
                 log=lambda msg: None):
        lap = common.Laps(log)
        self.system = systems.make(cfg["system"]["name"], cfg, datamodule,
                                   save_dir=common.scratch_dir(),
                                   device=device)
        lap("system built")
        self.data = self.system.device_data(datamodule.train())
        common.sync(device)
        lap("views on the card")
        self.gen = torch.Generator(device=device)
        self.every = int(occupancy_every)
        self.prune = bool(cfg["model"].get("grid_prune", True))
        self.num_rays = self.system.rank_counts(self.system.capacity)[0]
        self.occupancy_s = None  # a list when the sweeps are timed
        self.device, self.init_grid = device, init_grid
        self.reset(weights, seed, start_step, lap)

    def reset(self, weights, seed, start_step, lap=lambda what: None):
        """A fresh run from ``weights`` (a state dict; None: the seed's
        draw, for the reference's own model): a fresh optimizer, an
        all-occupied grid, the seed's draws."""
        if weights is None:
            common.draw_weights(self.system.model, seed, self.device)
        else:
            self.system.model.load_state_dict(weights)
        common.sync(self.device)
        lap("weights loaded")
        self.system.fresh_optimizer()
        common.sync(self.device)
        lap("optimizer")
        occs, binary = self.init_grid(self.system.model.grid_resolution,
                                      self.device)
        common.sync(self.device)
        lap("grid")
        self.state = {"step": int(start_step), "occs": occs,
                      "occ_binary": binary}
        self.seed = seed

    def sweep_due(self) -> bool:
        return self.prune and int(self.state["step"]) % self.every == 0

    def step(self) -> Dict:
        k = int(self.state["step"])
        if self.sweep_due():
            self.gen.manual_seed(common.step_seed(self.seed, 2 * k + 1))
            if self.occupancy_s is None:
                self.system.update_occupancy(self.state, self.gen)
            else:
                common.sync(self.device)
                t = time.perf_counter()
                self.system.update_occupancy(self.state, self.gen)
                common.sync(self.device)
                self.occupancy_s.append(time.perf_counter() - t)
        self.gen.manual_seed(common.step_seed(self.seed, 2 * k))
        batch = self.system.sample_batch(self.gen, self.data,
                                         num_rays=self.num_rays)
        return self.system.train_step(self.state, batch, self.gen)

    def compared_steps(self, n: int) -> Dict:
        """The first ``n`` steps, with each loss, the first gradient's
        norm by leaf (Adam's ``exp_avg / (1 - beta1)`` after one step)
        and the norm of each leaf's change over the ``n`` steps."""
        leaves = _optimizer_leaves(self.system)
        start = {name: p.detach().clone() for name, p, _ in leaves}
        out = {"loss": [], "grad": {}, "change": {}}
        for i in range(n):
            aux = self.step()
            out["loss"].append(float(aux["loss"]))
            if i == 0:
                opt = self.system.optimizer
                for name, p, group in leaves:
                    m = opt.state.get(p, {}).get("exp_avg")
                    out["grad"][name] = float("nan") if m is None else float(
                        torch.linalg.vector_norm(
                            m.double() / (1 - group["betas"][0])))
        for name, p, _ in leaves:
            out["change"][name] = float(torch.linalg.vector_norm(
                (p.detach() - start[name]).double()))
        return out


def reference_readings(cell, seed, device, datamodule, tf32=False,
                       deterministic=False) -> Dict:
    """The reference's compared steps from the seed's weights."""
    from .reference import systems
    from .reference.ops.grid import init_grid

    cfg, tr = cell.config["run"], cell.traffic
    torch.use_deterministic_algorithms(deterministic)
    ref = Trainer(systems, cfg, datamodule, None, seed, device,
                  tr["start_step"], tr["occupancy_every"], init_grid)
    if torch.device(device).type == "cuda":
        common.tf32(tf32)
    out = ref.compared_steps(int(tr["compared_steps"]))
    common.tf32(False)
    torch.use_deterministic_algorithms(False)
    return out


class Views:
    """A split's training views as ``device_data`` reads them."""

    def __init__(self, images, masks, c2w, directions):
        self.all_images, self.all_fg_masks = images, masks
        self.all_c2w, self.directions = c2w, directions


class Scene:
    """The configuration's training views, made by the reference's
    generator and handed to both sides; kept once made under
    ``_cache/scenes/`` (keyed by the dataset's settings; the seed does
    not change the scene)."""

    def __init__(self, dataset_cfg: dict):
        from .reference import datasets

        key = hashlib.sha256(json.dumps(dataset_cfg, sort_keys=True)
                             .encode()).hexdigest()[:16]
        path = CACHE / f"{dataset_cfg['name']}-{key}.npz"
        if path.exists():
            with np.load(path) as z:
                self.views = Views(*(z[k] for k in VIEW_KEYS))
            return
        split = datasets.make(dataset_cfg["name"], dataset_cfg).train()
        self.views = Views(*(getattr(split, k) for k in VIEW_KEYS))
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
        np.savez(tmp, **{k: getattr(self.views, k) for k in VIEW_KEYS})
        os.replace(tmp, path)

    def train(self):
        return self.views


VIEW_KEYS = ("all_images", "all_fg_masks", "all_c2w", "directions")
CACHE = Path(__file__).resolve().parent / "_cache" / "scenes"


def build(cell, seed, device, log=print):
    """The program's trainer with the seed's weights (set-up)."""
    import rise_sdf_tpu_torch.systems as systems

    from .reference import models
    from .reference.ops.grid import init_grid

    cfg, tr = cell.config["run"], cell.traffic
    if tr.get("deterministic", False):
        torch.use_deterministic_algorithms(True)
    lap = common.Laps(log)
    dm = Scene(cfg["dataset"])
    lap("scene")
    ref_model = common.reference_weights(models, cfg["model"], seed, device)
    weights = {k: v.detach().clone() for k, v in ref_model.state_dict().items()}
    dims = flops.mlp_dims(ref_model)
    del ref_model
    lap("weights")
    trainer = Trainer(systems, cfg, dm, weights, seed, device,
                      tr["start_step"], tr["occupancy_every"], init_grid, log)
    del weights
    return trainer, dm, dims


def run(cell, seed: int, seconds: float, traced: bool, device, clock,
        log) -> Dict:
    cfg, tr = cell.config["run"], cell.traffic
    log(f"process start to the cell's set-up {clock.since():.2f} s")
    trainer, dm, dims = build(cell, seed, device, log)
    lap = common.Laps(log)
    prog = trainer.compared_steps(int(tr["compared_steps"]))
    lap("compared steps")
    window_from = int(tr["start_step"]) + int(tr["warm_steps"])
    while int(trainer.state["step"]) < window_from:
        trainer.step()
    common.sync(device)
    lap("warm steps")
    setup_s = clock.since()
    log(f"set-up {setup_s:.1f} s; window from step {window_from}")

    if traced:
        trainer.occupancy_s = []
    live, rays, skipped, n = [], [], 0.0, 0
    capacity = trainer.system.train_options(window_from)["capacity"]
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        aux = trainer.step()
        skipped += float(aux["skipped_nonfinite"])
        if traced:
            # the live samples the step's buffer kept: the march counts
            # those of the rays it dropped too
            live.append(torch.clamp(aux["num_samples"], max=capacity))
            rays.append(aux["num_rays"])
        n += 1
    common.sync(device)
    window_s = time.perf_counter() - t0
    peak = common.memory_peak(device)
    res = {"attempted": n, "failed": int(skipped), "memory_peak": peak,
           "setup_s": setup_s, "rate": n / window_s,
           "rate_unit": "steps/s"}
    log(f"window: {n} steps in {window_s:.3f} s, {int(skipped)} skipped")

    if traced:
        per_step = [flops.train_step(dims, cfg, float(a), float(b))
                    for a, b in zip(live, rays)]
        while not trainer.sweep_due():
            trainer.step()
        period = int(tr["occupancy_every"])
        with common.traced_stretch(device, False) as dev:
            for _ in range(period):
                trainer.step()
        rec = launches.LaunchRecorder()
        with common.traced_stretch(device, True) as st, rec:
            for _ in range(period):
                trainer.step()
        res["trace"] = {
            "kind": "train", "device_events": dev["events"],
            "events": st["events"],
            "model_flops": sum(per_step), "flops_seconds": window_s,
            "spans": {"occupancy": trainer.occupancy_s},
            "launch_bytes": {k: rec.bytes_of(k) for k in launches.ENTRIES}}

    del trainer
    common.free(device)
    torch.use_deterministic_algorithms(False)
    t = time.perf_counter()
    ref = reference_readings(cell, seed, device, dm,
                             deterministic=tr.get("deterministic", False))
    log(f"reference {time.perf_counter() - t:.1f} s")
    res["numbers"] = compare.train_numbers(prog, ref)
    return res
