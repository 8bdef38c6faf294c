"""Learnable NeuS variance: ``inv_s = exp(10 * variance)``
(counterpart of ``rise_sdf_tpu/models/variance.py``), with the optional
modulation schedule: after ``mod_start_steps`` the value is capped by a
linear ramp from ``prev_inv_s`` (the value when modulation started) to
``max_inv_s``: ``cap = min((step / reach_max_steps) * (max_inv_s -
prev_inv_s) + prev_inv_s, max_inv_s)``.

``prev_inv_s`` is a float32 buffer, not a trained parameter.  The JAX
package keeps it in ``params`` (key ``variance/prev_inv_s``), so its
optimizer treats it as a leaf with a zero gradient: Adam leaves it
alone, AdamW decays it (``systems/optim.py`` hands the buffer to the
optimizer for that).  ``post_update`` tracks ``exp(10 * variance)`` into
it while ``step <= mod_start_steps``; after that only AdamW's decay
moves it.
"""

from __future__ import annotations

import torch
from torch import nn


class Variance(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.init_val = float(config["init_val"])
        self.modulate = bool(config.get("modulate", False))
        self.variance = nn.Parameter(torch.tensor(self.init_val))
        if self.modulate:
            self.mod_start_steps = int(config["mod_start_steps"])
            self.reach_max_steps = int(config["reach_max_steps"])
            self.max_inv_s = float(config["max_inv_s"])
            self.register_buffer("prev_inv_s", self._initial_prev())

    def _initial_prev(self):
        return torch.exp(torch.tensor(self.init_val * 10.0,
                                      dtype=torch.float32))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.variance.fill_(self.init_val)
        if self.modulate:
            self.prev_inv_s.copy_(self._initial_prev())

    def inv_s(self, step=None):
        """``exp(10 * variance)``, capped by the modulation ramp when
        ``step`` is given and past ``mod_start_steps``, then clamped to
        [1e-6, 1e6]."""
        val = torch.exp(self.variance * 10.0)
        if self.modulate and step is not None:
            step = float(step)
            prev = self.prev_inv_s
            cap = torch.clamp_max(
                (step / self.reach_max_steps) * (self.max_inv_s - prev)
                + prev, self.max_inv_s)
            if step > self.mod_start_steps:
                val = torch.minimum(val, cap)
        return torch.clamp(val, 1e-6, 1e6)

    @torch.no_grad()
    def post_update(self, step):
        """After the optimizer step: ``prev_inv_s`` tracks
        ``exp(10 * variance)`` while ``step <= mod_start_steps`` (it
        freezes at the last pre-modulation value, as JAX's
        ``post_update``); nothing without modulation."""
        if self.modulate and step <= self.mod_start_steps:
            self.prev_inv_s.copy_(torch.exp(self.variance * 10.0))
