"""What the train and render mixes share: the seed's streams, the
weights drawn on the device, the traced stretch and the scratch
directory."""

from __future__ import annotations

import contextlib
import gc
import tempfile
import time

import torch

from .reference import draws
from .yardstick import trace


def step_seed(seed: int, stream: int) -> int:
    """The generator seed of one draw stream of a run (a function of the
    run's seed alone, so every seed sees the same sizes of work)."""
    return (int(seed) % (1 << 40)) * 1_000_003 + stream


def scratch_dir() -> str:
    """A fresh directory under ``TMPDIR`` for the systems' save paths."""
    return tempfile.mkdtemp(prefix="benchmark-")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def draw_weights(model, seed: int, device):
    """A reference model's parameters drawn from ``seed`` on ``device``
    (``draws.Draws``: two buffers in two calls, handed out in the
    model's module order, so every model of one configuration draws the
    same)."""
    n = sum(p.numel() for p in model.parameters())
    model.reset_parameters(draws.Draws(seed, device, n))
    return model


def reference_weights(models, mcfg: dict, seed: int, device):
    """The reference model of ``mcfg`` on ``device`` with the seed's
    weights; the program takes its ``state_dict``."""
    return draw_weights(models.make(mcfg["name"], mcfg).to(device), seed,
                        device)


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device):
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


@contextlib.contextmanager
def traced_stretch(device, host_ops: bool):
    """``torch.profiler`` over the body, which starts and ends
    synchronised; yields a dict that receives ``events`` on exit.

    With ``host_ops`` it records the host's operations too, inside a
    host span ``trace.STRETCH`` (what the kernels' launches are tied to
    by ``launches.LaunchRecorder``); that slows the host several-fold,
    so the device's busy share comes from a stretch without them, which
    records the card's work and the CUDA runtime calls alone."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if on_card else []
    if host_ops or not on_card:
        acts.append(ProfilerActivity.CPU)
    out = {}
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(trace.STRETCH) if host_ops \
                else contextlib.nullcontext():
            sync(device)
            yield out
            sync(device)
    out["events"] = trace.kineto_events(prof)


class Clock:
    """Seconds since the process started its work (the first line of
    ``benchmarks.run``)."""

    def __init__(self, t0: float):
        self.t0 = t0

    def since(self) -> float:
        return time.perf_counter() - self.t0


class Laps:
    """Logs the seconds since the previous lap."""

    def __init__(self, log):
        self.log, self.t = log, time.perf_counter()

    def __call__(self, what: str):
        now = time.perf_counter()
        self.log(f"{what} {now - self.t:.2f} s")
        self.t = now


def tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
