"""Parameter draws: ``Draws`` hands out slices of two buffers drawn on
the device in two calls (one uniform, one normal), so a model's
``reset_parameters(Draws(...))`` fills every leaf from the seed without
a draw per leaf on the host.  ``rand`` and ``randn`` take a
``torch.Generator`` too, for the module code's own callers."""

from __future__ import annotations

import torch


class Draws:
    """``n`` uniform and ``n`` normal float32 draws from ``seed`` on
    ``device``, handed out in order."""

    def __init__(self, seed: int, device, n: int):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.uniform = torch.rand(n, generator=gen, device=device)
        self.normal = torch.randn(n, generator=gen, device=device)
        self.used = {"uniform": 0, "normal": 0}

    def take(self, kind: str, shape) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        n = 1
        for s in shape:
            n *= s
        buf, start = getattr(self, kind), self.used[kind]
        if start + n > buf.numel():
            raise ValueError(f"Draws: {kind} buffer of {buf.numel()} "
                             f"is exhausted")
        self.used[kind] = start + n
        return buf[start:start + n].view(shape)


def rand(generator, shape) -> torch.Tensor:
    if isinstance(generator, Draws):
        return generator.take("uniform", shape)
    return torch.rand(tuple(shape), generator=generator)


def randn(generator, shape) -> torch.Tensor:
    if isinstance(generator, Draws):
        return generator.take("normal", shape)
    return torch.randn(tuple(shape), generator=generator)


def device_of(generator) -> torch.device:
    """The device ``generator``'s draws land on (the CPU for None)."""
    if isinstance(generator, Draws):
        return generator.uniform.device
    return torch.device("cpu") if generator is None else generator.device
