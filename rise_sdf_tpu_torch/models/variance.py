"""Learnable NeuS variance: ``inv_s = exp(10 * variance)``
(counterpart of ``rise_sdf_tpu/models/variance.py``; the modulation
schedule is not ported yet)."""

from __future__ import annotations

import torch
from torch import nn


class Variance(nn.Module):
    def __init__(self, config):
        super().__init__()
        if bool(config.get("modulate", False)):
            raise NotImplementedError("variance modulation is not ported yet")
        self.init_val = float(config["init_val"])
        self.variance = nn.Parameter(torch.tensor(self.init_val))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.variance.fill_(self.init_val)

    def inv_s(self):
        return torch.clamp(torch.exp(self.variance * 10.0), 1e-6, 1e6)

    def post_update(self, step):
        """Buffer upkeep after the optimizer step: nothing without
        modulation (the JAX ``post_update`` tracks ``prev_inv_s`` only
        when ``modulate`` is on)."""
