"""Hash-encoded SDF field (counterpart of ``rise_sdf_tpu/models/geometry.py:
VolumeSDF``, analytic gradients only).

The gradient is ``torch.autograd.grad(raw[:, 0].sum(), x)``; with
``create_graph=True`` (training) the eikonal and RGB losses
differentiate through it, and the table side of the encode is still
differentiated once (``ops/scatter.py``).

A config that trains with finite differences (the flagship's
``grad_type: finite_difference``, ``fd_fine_k``, ``curvature_probe_frac``)
is accepted: its eval paths ask for ``grad_mode="analytic"`` or for no
gradient, as the JAX package's do.  Asking for a finite-difference
gradient raises ``NotImplementedError``."""

from __future__ import annotations

import torch
from torch import nn

from . import register
from ..nn import get_encoding, get_mlp


@register("volume-sdf")
class VolumeSDF(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.radius = float(config["radius"])
        self.feature_dim = int(config["feature_dim"])
        self.grad_type = config.get("grad_type", "analytic")
        if self.grad_type not in ("analytic", "finite_difference"):
            raise ValueError(f"unknown grad_type '{self.grad_type}'")
        if config.get("sdf_activation") is not None:
            raise NotImplementedError("sdf_activation is not ported yet")
        self.encoding = get_encoding(3, config["xyz_encoding_config"])
        self.mlp = get_mlp(self.encoding.n_output_dims, self.feature_dim,
                           config["mlp_network_config"])

    def contract(self, x):
        """World [-r, r]^3 -> unit cube [0, 1]^3 (AABB contraction)."""
        return (x + self.radius) / (2.0 * self.radius)

    def raw(self, x_world, step=None, levels=None):
        """-> [N, feature_dim]; channel 0 is the SDF."""
        # clamp into the unit cube: dead sample slots may lie outside the
        # AABB, where trilinear extrapolation weights blow up
        u = torch.clamp(self.contract(x_world), 0.0, 1.0)
        return self.mlp(self.encoding(u, step, levels=levels))

    def sdf(self, x_world, step=None, levels=None):
        return self.raw(x_world, step, levels)[..., 0]

    def forward(self, x_world, step=None, with_grad=True, with_feature=True,
                create_graph=False, levels=None, grad_mode=None):
        """Returns dict with sdf [N], grad [N,3], feature [N,F].

        ``grad_mode`` overrides the configured gradient type per call
        (eval paths pass "analytic").  ``create_graph``: keep the
        gradient differentiable (training).  The gradient needs autograd
        even under ``torch.no_grad()`` (eval), so it is taken under
        ``enable_grad``; an ``x_world`` that does not require grad is
        replaced by a detached copy that does."""
        grad_type = grad_mode or self.grad_type
        if with_grad and grad_type != "analytic":
            raise NotImplementedError(
                f"'{grad_type}' gradients (FD / hybrid FD) are not ported "
                "yet; eval paths use grad_mode='analytic'")
        out = {}
        if with_grad:
            with torch.enable_grad():
                x = x_world if x_world.requires_grad \
                    else x_world.detach().requires_grad_(True)
                raw = self.raw(x, step, levels)
                out["grad"], = torch.autograd.grad(
                    raw[:, 0].sum(), x, create_graph=create_graph)
        else:
            raw = self.raw(x_world, step, levels)
        out["sdf"] = raw[..., 0]
        if with_feature:
            out["feature"] = raw
        return out
