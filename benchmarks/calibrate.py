"""The readings that ``correct``'s limits are set from, on the card.

    python3 -m benchmarks.calibrate --workload <name> --seeds N \
        [--control-seeds M] [--fault-seeds K] [--first-seed S]

For each of ``N`` seeds, the program's compared numbers against the
reference (the lower reading's runs: set-up alone, as a run's set-up
takes them; a render compares its sampled chunks of the first image);
for ``M`` of them the control's, the reference computed at TF32 (the
precision below the configurations' float32) in the program's place
(the upper reading); for ``K`` of them, in a train cell, the program
with half of each batch left out (the fault that needs a run: a step
that leaves the state unchanged reads 1 by ``compare``'s measure).
All in one process, so that the set-up is paid once per seed.  Prints
one JSON line per reading and a summary line last.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import common
from .yardstick import compare


def half_batch(system):
    """The fault: ``forward_loss`` on the first half of each batch (an
    attribute of this system alone; ``del system.forward_loss`` mends
    it)."""
    orig = type(system).forward_loss.__get__(system)

    def forward_loss(batch, *args, **kw):
        n = batch["rays"].shape[0] // 2
        half = {k: (v[:n] if v.dim() and v.shape[0] == 2 * n else v)
                for k, v in batch.items()}
        return orig(half, *args, **kw)

    system.forward_loss = forward_loss


class TrainReadings:
    """The program's trainer and the reference's, each built once and
    reset for every seed."""

    def __init__(self, cell, seed, device):
        from . import train
        from .reference import models, systems
        from .reference.ops.grid import init_grid

        self.cell, self.device = cell, device
        self.det = bool(cell.traffic.get("deterministic", False))
        self.prog, dm, _ = train.build(cell, seed, device, log=lambda m: None)
        torch.use_deterministic_algorithms(False)
        cfg, tr = cell.config["run"], cell.traffic
        self.draw = models.make(cfg["model"]["name"], cfg["model"]).to(device)
        self.ref = train.Trainer(systems, cfg, dm, None, seed, device,
                                 tr["start_step"], tr["occupancy_every"],
                                 init_grid)

    def _steps(self, trainer, det, tf32=False):
        torch.use_deterministic_algorithms(det)
        common.tf32(tf32 and torch.device(self.device).type == "cuda")
        try:
            return trainer.compared_steps(
                int(self.cell.traffic["compared_steps"]))
        finally:
            common.tf32(False)
            torch.use_deterministic_algorithms(False)

    def __call__(self, seed, control, fault):
        start = self.cell.traffic["start_step"]
        common.draw_weights(self.draw, seed, self.device)
        weights = self.draw.state_dict()
        self.prog.reset(weights, seed, start)
        prog = self._steps(self.prog, self.det)
        self.ref.reset(None, seed, start)
        ref = self._steps(self.ref, self.det)
        out = {"program": compare.train_numbers(prog, ref)}
        if control:
            self.ref.reset(None, seed, start)
            out["control"] = compare.train_numbers(
                self._steps(self.ref, self.det, tf32=True), ref)
        if fault:
            self.prog.reset(weights, seed, start)
            half_batch(self.prog.system)
            try:
                out["fault"] = compare.train_numbers(
                    self._steps(self.prog, self.det), ref)
            finally:
                del self.prog.system.forward_loss
        return out


class RenderReadings:
    """The program's model and the reference's, each built once and
    given every seed's weights."""

    def __init__(self, cell, seed, device):
        from . import render
        from .reference import models

        self.cell, self.device = cell, device
        self.prog = render.build(cell, seed, device)
        mcfg = render.model_config(cell)
        self.ref = render.Renderer(
            models.make(mcfg["name"], mcfg).to(device), cell, device)

    def _answers(self, r, chunks, tf32=False):
        from .render import keep

        common.tf32(tf32 and torch.device(self.device).type == "cuda")
        try:
            with torch.no_grad():
                r.prepare_image()
                return {i: keep(r.chunk_out(i)) for i in chunks}
        finally:
            common.tf32(False)

    def __call__(self, seed, control, fault):
        from . import render

        variance = float(self.cell.traffic["variance"])
        common.draw_weights(self.ref.model, seed, self.device)
        with torch.no_grad():
            self.ref.model.variance.variance.fill_(variance)
        self.prog.model.load_state_dict(self.ref.model.state_dict())
        chunks = sorted(set(render.sampled_chunks(
            seed, len(self.prog.starts),
            int(self.cell.traffic["compared_chunks"]))) | {0})
        ref = self._answers(self.ref, chunks)
        out = {"program": render._answers(
            self._answers(self.prog, chunks), ref)}
        if control:
            out["control"] = render._answers(
                self._answers(self.ref, chunks, tf32=True), ref)
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None,
                    help="a checkout other than this one (tests)")
    args = ap.parse_args(argv)

    from pathlib import Path

    from . import cells, run

    kw = {} if args.root is None else {
        "root": Path(args.root), "here": Path(args.root) / "benchmarks"}
    cell = cells.load(args.workload, **kw)
    run._environment(cell.traffic)
    readings = {"train": TrainReadings, "render": RenderReadings}[
        cell.traffic["kind"]](cell, args.first_seed, args.device)
    summary = {"program": {}, "control": {}, "fault": {}}
    for i in range(args.seeds):
        seed = args.first_seed + 1_000_003 * i
        out = readings(seed, i < args.control_seeds, i < args.fault_seeds)
        print(json.dumps({"seed": seed, **out}), flush=True)
        for side, nums in out.items():
            for k, v in nums.items():
                summary[side].setdefault(k, []).append(v)
    agg = {side: {k: {"max": max(v), "min": min(v)} for k, v in d.items()}
           for side, d in summary.items() if d}
    print(json.dumps({"workload": args.workload, "summary": agg}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
