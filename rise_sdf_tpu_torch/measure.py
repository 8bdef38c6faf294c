"""Kernel timing and the NeuS slice's rate on one NVIDIA GPU, shared by
``chip_smoke.py`` and ``rise_sdf_tpu_torch.kernel_ab``.

    python -m rise_sdf_tpu_torch.measure [--steps 120]

trains ``neus_sphere_full`` (hash grid 16 x 2^19 x 2, 4096 rays x 1024
samples into a 1,048,576-sample buffer) for ``--steps`` steps and
validates one view; it prints one JSON line: steps/s over the last 60
steps, the validation PSNR, skipped updates, and the device time per
step with K1's and G1's share and launches, from ``torch.profiler`` over
steps 41-45.  Without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np
import torch

LEVELS, LOG2_T = 16, 19
S1_ROWS = 12582912
# the profiled train steps: after PROFILE_FROM, outside the rate's window
PROFILE_FROM, PROFILE_STEPS = 40, 5
RATE_WINDOW = 60


def median_ms(fn, reps=10, inner=10):
    """Median over ``reps`` samples of the device time per call of
    ``fn``, each sample a run of ``inner`` back-to-back calls between two
    CUDA events, so the host's launch overhead overlaps the device's
    work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def main_path_rows(gen):
    """Level-l rows drawn from [0, min((res_l+1)^3, 2^19)) + l * 2^19, as
    the encode of 1,048,576 samples x 8 corners gives them, level-major;
    and the flattened table's size."""
    t = 2 ** LOG2_T
    return torch.cat([
        torch.randint(0, min((int(16 * 1.447269237440378 ** l) + 1) ** 3, t),
                      (8 * 1048576,), generator=gen, device="cuda",
                      dtype=torch.int32) + l * t
        for l in range(LEVELS)]), LEVELS * t


def k1_shapes(gen):
    """K1's uniform shapes, one at a time: ``(name, (idx, vals,
    table_size, period))``.  S1's (12,582,912 rows into one 2^19 x 2
    level) and the main path's (16 levels, walked with the period of the
    encode's ``[N, 16, 8]`` rows)."""
    t = 2 ** LOG2_T
    idx = torch.randint(0, t, (S1_ROWS,), generator=gen, device="cuda",
                        dtype=torch.int32)
    yield (f"S1 shape: {S1_ROWS} rows into {t} x 2",
           (idx, torch.randn((S1_ROWS, 2), generator=gen, device="cuda"), t,
            1))
    idx, t = main_path_rows(gen)
    yield (f"main path: {idx.numel()} rows into {t} x 2, P = 128",
           (idx, torch.randn((idx.numel(), 2), generator=gen, device="cuda"),
            t, 128))


def g1_shapes(gen):
    """G1's uniform shapes, one at a time: ``(name, (table, idx))``.
    S2/S3's, S4's (w = 2, 8, 32), one render chunk's (the hash encode,
    49,152 samples x 16 levels x 8 corners into 16 x 2^19 x 2; the
    baked-SDF probe, 4096 rays x 64 probes into 129^3 x 8) and the main
    path's."""
    t = 2 ** LOG2_T

    def uniform(n, w, m):
        table = torch.randn((n, w), generator=gen, device="cuda")
        return table, torch.randint(0, n, (m,), generator=gen, device="cuda",
                                    dtype=torch.int32)

    yield "S2/S3 shape", uniform(t, 2, 8388608)
    for w in (2, 8, 32):
        yield f"S4 shape, w={w}", uniform(t, w, 4194304)
    yield "render chunk, hash encode", uniform(LEVELS * t, 2, 49152 * 16 * 8)
    yield "render chunk, baked-SDF probe", uniform(129 ** 3, 8, 4096 * 64)
    idx, n = main_path_rows(gen)
    yield "main path", (torch.randn((n, 2), generator=gen, device="cuda"), idx)


class StepProfile:
    """``torch.profiler`` over train steps ``PROFILE_FROM + 1`` to
    ``PROFILE_FROM + PROFILE_STEPS``; call it from ``fit``'s ``on_log``
    at every step."""

    def __init__(self):
        self.prof, self.t0, self.wall_ms = None, 0.0, 0.0

    def __call__(self, step):
        if step == PROFILE_FROM:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        elif step == PROFILE_FROM + PROFILE_STEPS:
            torch.cuda.synchronize()
            self.wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.__exit__(None, None, None)

    def per_step(self):
        """Wall and device ms per step; K1's and G1's device ms and
        launches per step; the eight largest kernels as ``[name, ms per
        step, launches per step]``."""
        from .bench import _kernel_times

        times = _kernel_times(self.prof)
        n = PROFILE_STEPS
        out = {"steps": n, "wall_ms": self.wall_ms / n,
               "device_ms": sum(t for t, _ in times.values()) / n}
        for key, name in (("k1", "scatter_add"), ("g1", "gather_rows")):
            hits = [v for k, v in times.items() if name in k]
            out[f"{key}_ms"] = sum(t for t, _ in hits) / n
            out[f"{key}_launches"] = sum(c for _, c in hits) / n
        top = sorted(times.items(), key=lambda kv: -kv[1][0])[:8]
        out["top"] = [[k[:90], t / n, c / n] for k, (t, c) in top]
        return out


def train(system, steps, seed, state, on_log=None):
    """``system.fit`` for ``steps`` steps, logging every step; steps past
    ``PROFILE_FROM + PROFILE_STEPS`` profile the window.  Returns the
    state, the per-step metrics, steps/s over the last ``RATE_WINDOW``
    steps (fewer in a short run) and ``StepProfile.per_step()`` (empty
    when the run is too short)."""
    stamps, metrics = [], []
    prof = StepProfile() if steps > PROFILE_FROM + PROFILE_STEPS else None

    def hook(step, m):
        stamps.append(time.perf_counter())
        metrics.append(m)
        if on_log is not None:
            on_log(step, m)
        if prof is not None:
            prof(step)

    state = system.fit(max_steps=steps, seed=seed, state=state, log_every=1,
                       on_log=hook)
    torch.cuda.synchronize()
    window = min(RATE_WINDOW, steps - 1)
    rate = window / (stamps[-1] - stamps[-1 - window])
    return state, metrics, rate, prof.per_step() if prof else {}


def main(argv=None):
    from . import datasets, systems
    from .presets import neus_sphere_full

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = neus_sphere_full()
    seed = int(cfg.get("seed", 42))
    save = os.path.join("exp", "measure")
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=save, device="cuda")
    state, _, rate, per_step = train(system, args.steps, seed,
                                     system.init_state(seed))
    psnr = float(system.validate(state, n_images=1)["psnr"])
    shutil.rmtree(save, ignore_errors=True)
    print(json.dumps({"steps_per_s": rate, "psnr": psnr,
                      "skipped": system.skipped_updates, **per_step}))


if __name__ == "__main__":
    main()
