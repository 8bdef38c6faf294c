"""The ``brdf-ggx`` scatterer of the Monte-Carlo path (counterpart of
``rise_sdf_tpu/models/scatterer.py``): a metallic-workflow GGX BRDF
sampled as an even mixture of a cosine lobe and visible-normal GGX.

``sample_from_uniforms`` is a pure function of three uniform tensors,
the roles of the JAX package's three keys: ``u_spec`` [..., 2] for the
half vector, ``u_diff`` [..., 2] for the cosine lobe and ``u_pick``
[...] for the choice between them.  ``sample`` draws them from a
``torch.Generator``.  The scatterer has no parameters; the JAX
methods' unused ``alpha_y``, ``attenuation`` (and, outside ``eval``,
``albedo`` and ``metallic``) are left out.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import register
from ..ops.warp import (_normalize, eval_ggx_ndf, eval_ggx_vndf_pdf,
                        fresnel_schlick, sample_ggx_vndf, smith_ggx_g1,
                        square_to_cosine_hemisphere, to_local, to_world)


@register("brdf-ggx")
class BRDFGGXScatterer(nn.Module):
    def __init__(self, config=None):
        super().__init__()
        self.config = config or {}
        self.min_alpha = float(self.config.get("min_alpha", 1e-3))

    def _alpha(self, alpha_x):
        return torch.clamp(alpha_x ** 2, min=self.min_alpha)

    def sample_from_uniforms(self, u_spec, u_diff, u_pick, n, wi, alpha_x):
        """Outgoing directions: ``wi`` reflected about a VNDF half vector
        where ``u_pick < 0.5``, a cosine-lobe direction elsewhere."""
        alpha = self._alpha(alpha_x)
        wi_l = to_local(wi, n)
        h_l = sample_ggx_vndf(wi_l, alpha, u_spec)
        wo_spec_l = 2.0 * torch.sum(wi_l * h_l, -1, keepdim=True) * h_l - wi_l
        wo_diff_l = square_to_cosine_hemisphere(u_diff)
        wo_l = torch.where((u_pick < 0.5)[..., None], wo_spec_l, wo_diff_l)
        return to_world(wo_l, n)

    @staticmethod
    def draw_uniforms(shape, generator: Optional[torch.Generator] = None,
                      device=None):
        """(u_spec, u_diff, u_pick) of ``shape`` directions."""
        shape = tuple(shape)
        return (torch.rand(shape + (2,), generator=generator, device=device),
                torch.rand(shape + (2,), generator=generator, device=device),
                torch.rand(shape, generator=generator, device=device))

    def sample(self, generator: Optional[torch.Generator], n, wi, alpha_x):
        """``sample_from_uniforms`` on uniforms drawn from ``generator``
        on ``alpha_x``'s device."""
        u = self.draw_uniforms(alpha_x.shape, generator, alpha_x.device)
        return self.sample_from_uniforms(*u, n, wi, alpha_x)

    def pdf(self, n, wi, wo, alpha_x):
        """[..., 1] solid-angle pdf of ``wo`` under the mixture."""
        alpha = self._alpha(alpha_x)
        wi_l = to_local(wi, n)
        wo_l = to_local(wo, n)
        h_l = _normalize(wi_l + wo_l)
        pdf_diff = torch.clamp(wo_l[..., 2], min=0.0) / math.pi
        jac = 1.0 / torch.clamp(
            4.0 * torch.abs(torch.sum(wo_l * h_l, -1)), min=1e-6)
        pdf_spec = eval_ggx_vndf_pdf(wi_l, h_l, alpha) * jac
        return (0.5 * pdf_diff + 0.5 * pdf_spec)[..., None]

    def eval(self, wi, n, wo, alpha_x, albedo, metallic):
        """(diffuse, specular) BRDF times cosine terms, each [..., 1] or
        [..., 3]."""
        alpha = self._alpha(alpha_x)
        wi_l = to_local(wi, n)
        wo_l = to_local(wo, n)
        cos_i = torch.clamp(wi_l[..., 2:3], 0.0, 1.0)
        cos_o = torch.clamp(wo_l[..., 2:3], 0.0, 1.0)
        h_l = _normalize(wi_l + wo_l)
        d = eval_ggx_ndf(alpha, h_l[..., 2])[..., None]
        g = (smith_ggx_g1(alpha, wi_l[..., 2])
             * smith_ggx_g1(alpha, wo_l[..., 2]))[..., None]
        f0 = 0.04 * (1 - metallic) + metallic * albedo
        f = fresnel_schlick(f0, torch.sum(wi_l * h_l, -1, keepdim=True))
        spec = d * g * f / torch.clamp(4.0 * cos_i, min=1e-6)
        diff = cos_o / math.pi
        return diff, spec * cos_o / torch.clamp(cos_o, min=1e-6)
