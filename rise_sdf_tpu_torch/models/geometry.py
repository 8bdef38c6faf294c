"""Hash-encoded SDF field (counterpart of ``rise_sdf_tpu/models/geometry.py:
VolumeSDF``).

Gradients are analytic, 6-point central (or 4-point tetrahedral) finite
differences with a progressive eps tied to the finest open hash level,
or, with a static open-level count, hybrid finite differences: the
coarse levels' Taylor expansion from ``encode_with_grad`` and the fine
band encoded exactly at the probes by ``encode_axis_probes``.  The
curvature probe ("laplace") takes the gradient at a random tangent
offset on every ``laplace_stride``-th sample.

The analytic gradient is ``torch.autograd.grad(raw[:, 0].sum(), x)``;
with ``create_graph=True`` (training) the eikonal and RGB losses
differentiate through it, as they do through the curvature probe's
gradient.  The table side of every encode is still differentiated once
(``ops/scatter.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn

from . import register
from .neus import _normalize
from ..nn import get_encoding, get_mlp

# regular tetrahedron vertices (unit after / sqrt(3))
_TETRA = ((1.0, 1.0, 1.0), (1.0, -1.0, -1.0),
          (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0))
_CENTRAL6 = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
             (0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
_PROBE_AXES = (0, 0, 1, 1, 2, 2)  # the axis each central-6 probe moves
_LAPLACE_EPS = 1e-4  # tangent offset of the curvature probe


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
        self.fd_eps_cfg = config.get("finite_difference_eps", 1e-3)
        self.fd_taylor_coarse = bool(config.get("fd_taylor_coarse", True))
        self.fd_probe_mode = str(config.get("fd_probe_mode", "central6"))
        if self.fd_probe_mode not in ("central6", "tetra4"):
            raise ValueError(f"unknown fd_probe_mode '{self.fd_probe_mode}'")
        frac = float(config.get("curvature_probe_frac", 1.0))
        self.laplace_stride = max(int(round(1.0 / max(frac, 1e-6))), 1)
        offsets = torch.tensor(_TETRA) / math.sqrt(3.0) \
            if self.fd_probe_mode == "tetra4" else torch.tensor(_CENTRAL6)
        self.register_buffer("fd_offsets", offsets, persistent=False)

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

    @torch.no_grad()
    def forward_level(self, x_world, step=None):
        """The SDF alone, without gradients: the level that marching
        tetrahedra extracts."""
        return self.sdf(x_world, step)

    # ------------------------------------------------------------------ #
    def _hash_grid(self):
        hg = getattr(self.encoding, "encoding", None)
        return hg if hasattr(hg, "encode_axis_probes") else None

    def open_levels(self, step: int):
        """Open-level count at ``step`` (None unless the encoding is a
        progressive hash grid)."""
        hg = self._hash_grid()
        if hg is None or not hg.progressive:
            return None
        return hg.current_level(step)

    def fd_eps(self, step, levels=None) -> float:
        """Finite-difference eps; "progressive" ties it to the finest open
        cell, ``2r / (base * scale^(levels - 1))``."""
        if isinstance(self.fd_eps_cfg, (int, float)):
            return float(self.fd_eps_cfg)
        if self.fd_eps_cfg != "progressive":
            raise ValueError(f"finite_difference_eps '{self.fd_eps_cfg}'")
        hg = self.encoding.encoding
        if not isinstance(levels, int):
            levels = hg.current_level(step if step is not None else 10 ** 9)
        grid_res = hg.base_resolution * hg.per_level_scale ** (levels - 1)
        return 2.0 * self.radius / grid_res

    def _fd_combine(self, sdf_d, eps):
        """[P, N] probe SDFs -> [N, 3] gradient estimate."""
        if self.fd_probe_mode == "tetra4":
            # sum_i v_i = 0 and sum_i v_i v_i^T = (4/3) I
            return (3.0 / (4.0 * eps)) * torch.einsum("pn,pd->nd", sdf_d,
                                                      self.fd_offsets)
        return 0.5 * (sdf_d[0::2] - sdf_d[1::2]).T / eps

    def _fd_fine_k(self) -> int:
        """Finest levels that take exact probe encodes: ``fd_fine_k``, or
        those whose cell is within ~4x of the progressive eps."""
        override = self.config.get("fd_fine_k", None)
        if override is not None:
            return max(int(override), 1)
        hg = self.encoding.encoding
        return max(int(math.ceil(math.log(4.0)
                                 / math.log(hg.per_level_scale))), 1)

    def _shared_probes_ok(self, levels: int) -> bool:
        """The shared-neighbourhood probe encode fits: central-6 probes
        that move at most one cell of every fine-band level (always, with
        the progressive eps; a numeric eps is checked against the finest
        level in range).  ``fd_shared_probes: false`` turns it off."""
        if not bool(self.config.get("fd_shared_probes", True)):
            return False
        if self.fd_probe_mode != "central6" or self._hash_grid() is None:
            return False
        if self.fd_eps_cfg == "progressive":
            return True
        hg = self.encoding.encoding
        res = float(hg.resolutions[min(levels, hg.n_levels) - 1])
        return float(self.fd_eps_cfg) / (2.0 * self.radius) * res <= 1.0

    def _probe_points(self, x_world, eps):
        """[P, N, 3] FD probe positions, clipped to the AABB."""
        xd = x_world[None, :, :] + eps * self.fd_offsets[:, None, :]
        return torch.clamp(xd, -self.radius, self.radius)

    def analytic_grad(self, x_world, step=None, levels=None,
                      create_graph=False):
        """d sdf / d x at ``x_world``, differentiable with
        ``create_graph``."""
        with torch.enable_grad():
            x = x_world if x_world.requires_grad \
                else x_world.detach().requires_grad_(True)
            g, = torch.autograd.grad(self.sdf(x, step, levels).sum(), x,
                                     create_graph=create_graph)
        return g

    @staticmethod
    def _angle(grad_s, grad_d):
        dot = torch.sum(_normalize(grad_s) * _normalize(grad_d), -1)
        return torch.arccos(torch.clamp(dot, -1.0 + 1e-6, 1.0 - 1e-6)) \
            / math.pi

    def _tangent(self, grad_s, dirs):
        """Curvature-probe offset directions: ``normal x normalize(dirs)``
        (``dirs`` are uniform [0, 1)^3 draws, as the JAX probe's)."""
        return torch.linalg.cross(_normalize(grad_s), _normalize(dirs),
                                  dim=-1)

    def _hybrid_fd(self, x_world, step, levels, with_laplace, laplace_dirs,
                   create_graph):
        """FD gradient with Taylor-expanded coarse levels.

        The coarse band [0, fine_lo) is linear within a cell, so its
        features at a probe are ``c0 + J du`` from one gather at the base
        point; the fine band [fine_lo, levels) is encoded exactly at the
        probes.  The curvature probe's offset (1e-4) is far below any
        cell, so its gradient uses the same expansion, frozen at the base
        point, plus the exact fine levels."""
        comp = self.encoding
        hg = comp.encoding
        fine_lo = max(levels - self._fd_fine_k(), 0)
        u = torch.clamp(self.contract(x_world), 0.0, 1.0)
        c0, (jx, jy, jz) = hg.encode_with_grad(u, step, levels=(0, fine_lo))

        def enc_fine(uu):
            return hg(uu, step, levels=(fine_lo, levels))

        def full_enc(uu, du, fine_feats, base):
            b0, bx, by, bz = base
            e = (b0 + bx * du[..., 0:1] + by * du[..., 1:2]
                 + bz * du[..., 2:3] + fine_feats)
            if comp.include_xyz:
                e = torch.cat([uu * comp.xyz_scale + comp.xyz_offset, e], -1)
            return e

        eps = self.fd_eps(step, levels)
        ud = torch.clamp(self.contract(self._probe_points(x_world, eps)),
                         0.0, 1.0)                              # [P, N, 3]
        p, n = ud.shape[0], x_world.shape[0]
        if self._shared_probes_ok(levels):
            fine_all = hg.encode_axis_probes(u, ud, _PROBE_AXES, step,
                                             levels=(fine_lo, levels))
            fine_u, fine_d = fine_all[0], fine_all[1:]
        else:
            fine_u = enc_fine(u)
            fine_d = enc_fine(ud.reshape(-1, 3)).reshape(p, n, -1)

        base = (c0, jx, jy, jz)
        raw0 = self.mlp(full_enc(u, torch.zeros_like(u), fine_u, base))
        enc_d = full_enc(ud, ud - u[None], fine_d, base)
        sdf_d = self.mlp(enc_d.reshape(p * n, -1))[..., 0].reshape(p, n)
        grad = self._fd_combine(sdf_d, eps)

        laplace = None
        if with_laplace:
            s = self.laplace_stride
            grad_s, us = grad[::s], u[::s]
            base_s = (c0[::s], jx[::s], jy[::s], jz[::s])
            ut = torch.clamp(self.contract(
                x_world[::s] + _LAPLACE_EPS
                * self._tangent(grad_s, laplace_dirs)), 0.0, 1.0)
            # d sdf / d u / (2r): the coarse term is the frozen Jacobian,
            # the fine term the exact trilinear gradient at the offset
            with torch.enable_grad():
                if not ut.requires_grad:
                    ut = ut.detach().requires_grad_(True)
                s_sum = self.mlp(full_enc(ut, ut - us, enc_fine(ut),
                                          base_s))[..., 0].sum()
                grad_d, = torch.autograd.grad(s_sum, ut,
                                              create_graph=create_graph)
            laplace = self._angle(grad_s, grad_d / (2.0 * self.radius))
        return raw0, grad, laplace

    def forward(self, x_world, step=None, with_grad=True, with_feature=True,
                create_graph=False, levels=None, grad_mode=None,
                with_laplace=False, laplace_dirs=None):
        """Returns dict with sdf [N], grad [N,3], feature [N,F] and, with
        ``with_laplace``, laplace [ceil(N / laplace_stride)].

        ``grad_mode`` overrides the configured gradient type per call
        (eval paths pass "analytic").  A finite-difference gradient with
        an int ``levels`` (the static open-level count) takes the hybrid
        path, with any other ``levels`` plain FD.  ``create_graph``: keep
        the analytic gradient and the curvature probe's differentiable
        (training).  ``laplace_dirs`` [ceil(N / laplace_stride), 3] are
        the curvature probe's uniform [0, 1)^3 draws.  The analytic
        gradient needs autograd even under ``torch.no_grad()`` (eval), so
        it is taken under ``enable_grad``; an ``x_world`` that does not
        require grad is replaced by a detached copy that does."""
        grad_type = grad_mode or self.grad_type
        if grad_type not in ("analytic", "finite_difference"):
            raise ValueError(f"unknown grad_mode '{grad_type}'")
        if with_laplace and (not with_grad or laplace_dirs is None):
            raise ValueError("the curvature probe needs with_grad and "
                             "laplace_dirs")
        out = {}
        if (with_grad and grad_type == "finite_difference"
                and self.fd_taylor_coarse and isinstance(levels, int)
                and self._hash_grid() is not None):
            raw, out["grad"], laplace = self._hybrid_fd(
                x_world, step, levels, with_laplace, laplace_dirs,
                create_graph)
            if with_laplace:
                out["laplace"] = laplace
        elif with_grad and grad_type == "analytic":
            with torch.enable_grad():
                x = x_world if x_world.requires_grad \
                    else x_world.detach().requires_grad_(True)
                raw = self.raw(x, step, levels)
                out["grad"], = torch.autograd.grad(
                    raw[:, 0].sum(), x, create_graph=create_graph)
        else:
            raw = self.raw(x_world, step, levels)
            if with_grad:
                eps = self.fd_eps(step, levels)
                xd = self._probe_points(x_world, eps)
                p, n = xd.shape[0], x_world.shape[0]
                sdf_d = self.sdf(xd.reshape(-1, 3), step,
                                 levels).reshape(p, n)
                out["grad"] = self._fd_combine(sdf_d, eps)
        if with_laplace and "laplace" not in out:
            # PermutoSDF curvature probe with the analytic gradient
            s = self.laplace_stride
            xs, grad_s = x_world[::s], out["grad"][::s]
            xd = xs + _LAPLACE_EPS * self._tangent(grad_s, laplace_dirs)
            out["laplace"] = self._angle(
                grad_s, self.analytic_grad(xd, step, levels, create_graph))
        out["sdf"] = raw[..., 0]
        if with_feature:
            out["feature"] = raw
        return out
