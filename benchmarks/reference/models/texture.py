"""Appearance heads (counterpart of ``rise_sdf_tpu/models/texture.py``).

* ``VolumeRadiance``: features, SH(dirs) and extras -> rgb (NeuS).
* ``VolumeColor``: features alone -> rgb (NeuS; the direction and normal
  it is handed go unused).
* ``VolumeMixedMipSplitOcc``: the flagship's five heads (albedo +
  diffuse, roughness, blend + metallic, NN specular, secondary
  radiance) with split-sum shading against the mip-cubemap emitter and
  the FG table (``ops/fg_lut.py``).  ``apply`` is ``material_cache``
  (everything that does not depend on the light) then ``shade_cached``;
  the relighting third bounce splits the same way
  (``secondary_pbr_cache``, then ``secondary_shade_pbr_cached`` per
  light).
* ``VolumeSplitSumMip``: the split sum alone (albedo 3, roughness 1,
  metallic 1 and the secondary head).  Its ``apply`` returns the
  physically based channels only, no ``diff_rgb``, ``spec_rgb`` or
  ``blend``, as the JAX head does, so neither flagship's forward takes
  it (both raise ``KeyError``).
* ``VolumePBR``: the Monte-Carlo GGX path: one direction per sample from
  the ``brdf-ggx`` scatterer, the caller's ``compute_indirect`` along
  it, the emitter's base lookup, weighted by BRDF over pdf.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import make, register
from ..nn import get_activation, get_encoding, get_mlp
from ..ops.cubemap import sample_texture2d
from ..ops.fg_lut import fg_lut


def _reflect(wi, n):
    """Mirror ``wi`` about ``n`` (both [..., 3])."""
    return 2.0 * torch.sum(wi * n, -1, keepdim=True) * n - wi


@register("volume-radiance")
class VolumeRadiance(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.n_dir_dims = int(config.get("n_dir_dims", 3))
        self.n_output_dims = 3
        self.encoding = get_encoding(self.n_dir_dims,
                                     config["dir_encoding_config"])
        self.n_input_dims = int(config["input_feature_dim"]) + \
            self.encoding.n_output_dims
        self.mlp = get_mlp(self.n_input_dims, 3, config["mlp_network_config"])
        self.color_activation = get_activation(
            config.get("color_activation", None))

    def forward(self, features, dirs, *args, step=None):
        """Input order as the JAX head: features, SH(dirs), then extras
        (NeuS passes the normal: 48 + 16 + 3 = 67 at neus-blender)."""
        enc = self.encoding((dirs + 1.0) / 2.0, step)
        inp = torch.cat([features, enc] + list(args), dim=-1)
        return self.color_activation(self.mlp(inp))


@register("volume-color")
class VolumeColor(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.mlp = get_mlp(int(config["input_feature_dim"]), 3,
                           config["mlp_network_config"])
        self.color_activation = get_activation(
            config.get("color_activation", None))

    def forward(self, features, *args, step=None):
        return self.color_activation(self.mlp(features))


@register("volume-mixed-mip-split-occ")
class VolumeMixedMipSplitOcc(nn.Module):
    """Five-head appearance model with split-sum PBR.  Stage 0 gives the
    NN radiance split (diffuse, specular, blend); stage 1 adds the
    physically based branch.  Head names follow the JAX params tree
    (``secondary``, ``albedo``, ``roughness``, ``metallic``, ``env``)."""

    # material_cache / shade_cached split (multi-emitter eval)
    supports_multi_emitter = True

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.n_dir_dims = int(config.get("n_dir_dims", 3))
        self.n_pos_dims = int(config.get("n_pos_dims", 3))
        self.dir_encoding = get_encoding(self.n_dir_dims,
                                         config["dir_encoding_config"])
        self.xyz_encoding = get_encoding(self.n_pos_dims,
                                         config["xyz_encoding_config"])
        fdim = int(config["input_feature_dim"])
        other = int(config.get("other_dim", 3))
        xdim = self.xyz_encoding.n_output_dims
        ddim = self.dir_encoding.n_output_dims
        self.secondary = get_mlp(fdim + other + ddim, 3,
                                 config["secondary_mlp_network_config"])
        self.albedo = get_mlp(fdim + xdim, 6,
                              config["albedo_mlp_network_config"])
        self.roughness = get_mlp(fdim + xdim, 1,
                                 config["roughness_mlp_network_config"])
        self.metallic = get_mlp(fdim + xdim, 2,
                                config["metallic_mlp_network_config"])
        self.env = get_mlp(fdim + ddim, 3, config["spec_mlp_network_config"])
        self.color_activation = get_activation(
            config.get("color_activation", None))
        self.register_buffer("fg", torch.from_numpy(fg_lut(256)),
                             persistent=False)

    def _material_heads(self, features, positions, step=None):
        inp = torch.cat([features, self.xyz_encoding(positions, step)], -1)
        act = self.color_activation
        alb6 = self.albedo(inp)
        met2 = self.metallic(inp)
        return (act(alb6[..., :3]), act(alb6[..., 3:]),
                act(self.roughness(inp)), act(met2[..., :1]),
                act(met2[..., 1:]))

    def _split_sum(self, albedo, roughness, metallic, normals, wo, nov,
                   emitter, mips):
        """Split-sum shading: (diffuse, specular, specular reflectance,
        specular light), the specular light looked up along ``wo``."""
        diff_rgb_pbr = (1 - metallic) * albedo * emitter.eval_mip(mips,
                                                                  normals)
        specular_albedo = 0.04 * (1 - metallic) + metallic * albedo
        specular_light = emitter.eval_mip(mips, wo, specular=True,
                                          roughness=roughness)
        fg_uv = torch.cat([torch.clamp(nov, 0.0, 1.0),
                           torch.clamp(roughness, 0.0, 1.0)], -1)
        fg = sample_texture2d(self.fg, fg_uv)
        specular_ref = specular_albedo * fg[..., 0:1] + fg[..., 1:2]
        return diff_rgb_pbr, specular_ref * specular_light, specular_ref, \
            specular_light

    def material_cache(self, features, dirs, normals, positions,
                       stage: int = 0, step=None):
        """The light-independent part of ``apply``: the material heads,
        the NN radiance branch and the FG-table term of the split sum."""
        wi = -dirs
        wo = _reflect(wi, normals)
        nov = torch.sum(normals * wi, -1, keepdim=True)
        diff_rgb, albedo, roughness, blend, metallic = self._material_heads(
            features, positions, step)
        wo_enc = self.dir_encoding((wo + 1.0) / 2.0, step)
        spec_rgb = self.color_activation(
            self.env(torch.cat([features, wo_enc], -1)))
        cache = {"diff_rgb": (1 - blend) * diff_rgb,
                 "spec_rgb": blend * spec_rgb, "blend": blend}
        if stage == 0:
            return cache
        specular_albedo = 0.04 * (1 - metallic) + metallic * albedo
        fg_uv = torch.cat([torch.clamp(nov, 0.0, 1.0),
                           torch.clamp(roughness, 0.0, 1.0)], -1)
        fg = sample_texture2d(self.fg, fg_uv)
        cache.update({
            "albedo": albedo, "metallic": metallic, "roughness": roughness,
            "diffuse_albedo": (1 - metallic) * albedo,
            "spec_ref": specular_albedo * fg[..., 0:1] + fg[..., 1:2],
            "normals": normals, "wo": wo,
        })
        return cache

    def shade_cached(self, cache, emitter, mips, stage: int = 0):
        """The light-dependent rest: two mip-cubemap lookups and
        per-sample arithmetic."""
        out = {k: cache[k] for k in ("diff_rgb", "spec_rgb", "blend")}
        if stage == 0:
            return out
        diffuse_light = emitter.eval_mip(mips, cache["normals"])
        specular_light = emitter.eval_mip(mips, cache["wo"], specular=True,
                                          roughness=cache["roughness"])
        out.update({
            "diff_rgb_pbr": cache["diffuse_albedo"] * diffuse_light,
            "spec_rgb_pbr": cache["spec_ref"] * specular_light,
            "spec_ref": cache["spec_ref"], "spec_light": specular_light,
            "albedo": cache["albedo"], "metallic": cache["metallic"],
            "roughness": cache["roughness"],
        })
        return out

    def apply(self, features, dirs, normals, positions, emitter=None,
              mips=None, stage: int = 0, step=None):
        """Per-sample appearance; all inputs [N, .] -> channel dict."""
        cache = self.material_cache(features, dirs, normals, positions,
                                    stage=stage, step=step)
        return self.shade_cached(cache, emitter, mips, stage=stage)

    def secondary_shading(self, features, rays_d, *args, step=None):
        """NN radiance for the secondary (reflected) rays."""
        enc = self.dir_encoding((rays_d + 1.0) / 2.0, step)
        inp = torch.cat([features, enc] + list(args), -1)
        return self.color_activation(self.secondary(inp))

    def secondary_pbr_cache(self, features, dirs, normals, positions,
                            step=None):
        """The light-independent half of ``secondary_shading_pbr``: the
        material heads at the third-bounce hit."""
        nov = torch.sum(normals * -dirs, -1, keepdim=True)
        _, albedo, roughness, _, metallic = self._material_heads(
            features, positions, step)
        return {"albedo": albedo, "roughness": roughness,
                "metallic": metallic, "normals": normals, "dirs": dirs,
                "nov": nov}

    def secondary_shade_pbr_cached(self, cache, emitter, mips):
        """Split-sum radiance at the third-bounce hit under one light.
        The specular light is looked up along the incoming direction
        ``dirs`` (the mirror bounce), as the reference does."""
        diff, spec, _, _ = self._split_sum(
            cache["albedo"], cache["roughness"], cache["metallic"],
            cache["normals"], cache["dirs"], cache["nov"], emitter, mips)
        return diff + spec

    def secondary_shading_pbr(self, features, dirs, normals, positions,
                              emitter, mips, step=None):
        """Full split sum at a secondary hit: cache, then shade."""
        return self.secondary_shade_pbr_cached(
            self.secondary_pbr_cache(features, dirs, normals, positions,
                                     step), emitter, mips)


@register("volume-pbr")
class VolumePBR(nn.Module):
    """The Monte-Carlo GGX path: the ``scatterer`` config names the BRDF
    (``brdf-ggx``); ``global_illumination`` (default on) adds the
    indirect radiance to the emitter's."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.scatterer = make(config["scatterer"]["name"],
                              config["scatterer"])
        self.global_illumination = bool(config.get("global_illumination",
                                                   True))

    def forward(self, positions, dirs, normals, albedo, roughness, metallic,
                compute_indirect, emitter, emitter_base=None,
                generator: Optional[torch.Generator] = None,
                uniforms=None):
        """Per-sample radiance {rgb_phys, diffuse_color, specular_color}.
        One secondary direction per sample, from ``uniforms`` (the
        scatterer's ``(u_spec, u_diff, u_pick)``) or drawn from
        ``generator``, held constant for the gradient.
        ``compute_indirect(origins, dirs)`` -> (transmittance [N, 1],
        radiance [N, 3]); the emitter's base is its own, or
        ``emitter_base``."""
        wi = -dirs
        alpha = roughness[..., 0]
        sc = self.scatterer
        if uniforms is None:
            uniforms = sc.draw_uniforms(alpha.shape, generator, alpha.device)
        secondary_d = sc.sample_from_uniforms(*uniforms, normals, wi,
                                              alpha).detach()
        secondary_tr, secondary_rgb = compute_indirect(positions, secondary_d)
        pdf = sc.pdf(normals, wi, secondary_d, alpha)
        pdf = torch.where(pdf > 0, pdf, torch.ones_like(pdf))
        diff, spec = sc.eval(wi, normals, secondary_d, alpha, albedo=albedo,
                             metallic=metallic)
        li = emitter.eval_base(secondary_d, emitter_base) * secondary_tr
        if self.global_illumination:
            li = li + secondary_rgb
        lo_diff = (1.0 - metallic) * albedo * li * diff / pdf
        lo_spec = li * spec / pdf
        return {"rgb_phys": lo_diff + lo_spec, "diffuse_color": lo_diff,
                "specular_color": lo_spec}


@register("volume-split-sum-mip-occ")
class VolumeSplitSumMip(VolumeMixedMipSplitOcc):
    """The split sum without the NN radiance branch: heads ``albedo``
    (3), ``roughness`` (1), ``metallic`` (1) and ``secondary``."""

    # no NN radiance branch, so no material_cache / shade_cached split
    supports_multi_emitter = False

    def __init__(self, config):
        nn.Module.__init__(self)
        self.config = config
        self.n_dir_dims = int(config.get("n_dir_dims", 3))
        self.n_pos_dims = int(config.get("n_pos_dims", 3))
        self.dir_encoding = get_encoding(self.n_dir_dims,
                                         config["dir_encoding_config"])
        self.xyz_encoding = get_encoding(self.n_pos_dims,
                                         config["xyz_encoding_config"])
        fdim = int(config["input_feature_dim"])
        other = int(config.get("other_dim", 3))
        xdim = self.xyz_encoding.n_output_dims
        ddim = self.dir_encoding.n_output_dims
        self.secondary = get_mlp(fdim + other + ddim, 3,
                                 config["secondary_mlp_network_config"])
        self.albedo = get_mlp(fdim + xdim, 3,
                              config["albedo_mlp_network_config"])
        self.roughness = get_mlp(fdim + xdim, 1,
                                 config["roughness_mlp_network_config"])
        self.metallic = get_mlp(fdim + xdim, 1,
                                config["metallic_mlp_network_config"])
        self.color_activation = get_activation(
            config.get("color_activation", None))
        self.register_buffer("fg", torch.from_numpy(fg_lut(256)),
                             persistent=False)

    def _material_heads(self, features, positions, step=None):
        inp = torch.cat([features, self.xyz_encoding(positions, step)], -1)
        act = self.color_activation
        return (None, act(self.albedo(inp)), act(self.roughness(inp)), None,
                act(self.metallic(inp)))

    def apply(self, features, dirs, normals, positions, emitter=None,
              mips=None, stage: int = 1, step=None):
        """The split-sum channels of every sample (``stage`` unused)."""
        wi = -dirs
        wo = _reflect(wi, normals)
        nov = torch.sum(normals * wi, -1, keepdim=True)
        _, albedo, roughness, _, metallic = self._material_heads(
            features, positions, step)
        diff_pbr, spec_pbr, spec_ref, spec_light = self._split_sum(
            albedo, roughness, metallic, normals, wo, nov, emitter, mips)
        return {
            "diff_rgb_pbr": diff_pbr, "spec_rgb_pbr": spec_pbr,
            "spec_ref": spec_ref, "spec_light": spec_light,
            "albedo": albedo, "metallic": metallic, "roughness": roughness,
        }
