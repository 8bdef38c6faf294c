"""Mip-cubemap environment light for split-sum shading (counterpart of
``rise_sdf_tpu/models/light.py:EnvLightMipCube``).

The learnable base cubemap ``base`` [6, R, R, 3] is the module's one
parameter.  ``build_mips`` makes the filtered pyramid from it: an
avg-pool chain down to 16^2, the cosine-filtered 16^2 diffuse map and
one GGX-filtered map per level (``ops/prefilter.py``, whose filter bank
is built on the host when the module is made).  ``eval_mip`` is a
bilinear lookup in the diffuse map, or a trilinear lookup over the
specular levels through their flattened atlas.

With ``hdr_filepath`` the base starts from a lat-long ``.exr`` or
Radiance ``.hdr`` file (clamped to [0, 1] when ``clamp``; NMF's mirrored
azimuth when ``nmf_format``); ``relight_params`` loads a relighting environment the
same way, without the clamp, and ``build_mips(base)`` filters it.

The Monte-Carlo half: ``eval_base`` looks up the raw base cubemap;
``update_pdf`` builds the importance-sampling CDFs over a lat-long
projection of the base (brightest channel times sin(theta)); ``sample``
inverts them, ``pdf`` gives a direction's solid-angle density under
them, and ``sample_stratified`` jitters a lat-long grid (TensoIR's
sampler).  The samplers take their uniforms, or a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import register
from .. import trace
from ..ops import prefilter
from ..ops.cubemap import avg_pool_cubemap, blender_latlong_to_cubemap, \
    cubemap_to_latlong, mips_atlas, nmf_latlong_to_cubemap, sample_cubemap, \
    sample_cubemap_mips_atlas
from ..utils.exr import read_exr
from ..utils.hdr import read_hdr

MIN_ROUGHNESS = prefilter.MIN_ROUGHNESS
MAX_ROUGHNESS = prefilter.MAX_ROUGHNESS
LIGHT_MIN_RES = prefilter.LIGHT_MIN_RES


def load_hdr_image(path: str) -> np.ndarray:
    """A lat-long ``.exr`` or Radiance ``.hdr`` (RGBE) image as float32
    RGB [H, W, 3]."""
    if path.endswith(".exr"):
        return np.ascontiguousarray(read_exr(path)[..., :3])
    if path.endswith(".hdr"):
        return read_hdr(path)
    raise ValueError(f"{path}: environment maps are read from .exr or "
                     ".hdr files")


class EnvMips(NamedTuple):
    diffuse: torch.Tensor                      # [6, 16, 16, 3]
    specular: List[torch.Tensor]               # per level [6, N_l, N_l, 3]
    atlas: Tuple[torch.Tensor, torch.Tensor]   # mips_atlas(specular)


@register("envlight-mip-cube")
class EnvLightMipCube(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        ec = config["envlight_config"]
        self.base_res = int(ec.get("base_res", 512))
        self.scale = float(ec.get("scale", 0.5))
        self.bias = float(ec.get("bias", 0.25))
        self.clamp = bool(ec.get("clamp", False))
        self.nmf_format = bool(ec.get("nmf_format", False))
        self.hdr_filepath = ec.get("hdr_filepath", None)
        self.n_levels = 1
        r = self.base_res
        while r > LIGHT_MIN_RES:
            r //= 2
            self.n_levels += 1
        self.base = nn.Parameter(torch.empty(6, self.base_res, self.base_res,
                                             3))
        # numpy, on the host, once (cached on disk by ops/prefilter.py)
        self.filters = prefilter.build_specular_filter_bank(self.base_res)
        self._on_device = {}
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Uniform in [bias, bias + scale), or the ``hdr_filepath`` map."""
        if self.hdr_filepath is None:
            self.base.copy_(torch.rand(self.base.shape, generator=generator)
                            * self.scale + self.bias)
            return
        latlong = torch.from_numpy(load_hdr_image(self.hdr_filepath))
        if self.clamp:
            latlong = torch.clamp(latlong, 0.0, 1.0)
        self.base.copy_(self._to_cubemap(latlong.to(self.base.device)))

    def _to_cubemap(self, latlong):
        conv = nmf_latlong_to_cubemap if self.nmf_format \
            else blender_latlong_to_cubemap
        return conv(latlong, self.base_res).float()

    def relight_params(self, file_name: str) -> dict:
        """``{"base": [6, R, R, 3]}`` of the lat-long file, on the base's
        device (not clamped, not trainable)."""
        latlong = torch.from_numpy(load_hdr_image(file_name))
        return {"base": self._to_cubemap(latlong.to(self.base.device))}

    def generate_image(self):
        """The learned light as a 512 x 1024 lat-long image (y up)."""
        return cubemap_to_latlong(self.base.detach(), (512, 1024))

    def _device_filters(self, device, dtype):
        """The diffuse matrix and the specular filters as tensors on
        ``device`` in ``dtype`` (copied once per device and type)."""
        key = (str(device), dtype)
        if key not in self._on_device:
            self._on_device[key] = (
                torch.as_tensor(prefilter.diffuse_filter_matrix(LIGHT_MIN_RES),
                                dtype=dtype, device=device),
                [prefilter.to_torch(f, device, dtype) for f in self.filters])
        return self._on_device[key]

    @trace.spanned("eval.build_mips")
    def build_mips(self, base: Optional[torch.Tensor] = None) -> EnvMips:
        """Differentiable mip build (reference ``light.py:169-180``) of
        the learned base, or of ``base`` (a relighting environment)."""
        base = self.base if base is None else base
        chain = [base]
        while chain[-1].shape[1] > LIGHT_MIN_RES:
            chain.append(avg_pool_cubemap(chain[-1]))
        matrix, filters = self._device_filters(base.device, base.dtype)
        diffuse = prefilter.apply_diffuse_filter(chain[-1], matrix)
        specular = [prefilter.apply_specular_level_filter(f, chain)
                    for f in filters]
        return EnvMips(diffuse, specular, mips_atlas(specular))

    def get_mip(self, roughness):
        """Roughness -> fractional mip level (reference ``light.py:182-185``)."""
        n = self.n_levels
        lo = (torch.clamp(roughness, MIN_ROUGHNESS, MAX_ROUGHNESS)
              - MIN_ROUGHNESS) / (MAX_ROUGHNESS - MIN_ROUGHNESS) * (n - 2)
        hi = (torch.clamp(roughness, MAX_ROUGHNESS, 1.0) - MAX_ROUGHNESS) \
            / (1.0 - MAX_ROUGHNESS) + n - 2
        return torch.where(roughness < MAX_ROUGHNESS, lo, hi)

    def eval_mip(self, mips: EnvMips, directions, specular: bool = False,
                 roughness=None):
        """[N, 3] directions -> [N, 3] radiance."""
        if specular:
            mip = self.get_mip(roughness)
            if mip.dim() == directions.dim():
                mip = mip[..., 0]
            return sample_cubemap_mips_atlas(mips.specular, directions, mip,
                                             atlas=mips.atlas)
        return sample_cubemap(mips.diffuse, directions)

    def eval_base(self, directions, base: Optional[torch.Tensor] = None):
        """[N, 3] directions -> [N, 3] radiance of the base cubemap (or of
        ``base``), bilinear."""
        return sample_cubemap(self.base if base is None else base,
                              directions)

    def update_pdf(self, res=(128, 256), base: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """``{"pdf" [H, W], "rows" [H + 1], "cols" [H, W + 1]}``: the
        normalised pdf over a lat-long projection of the base (or of
        ``base``) at ``res`` and its row and per-row column CDFs."""
        base = self.base if base is None else base
        img = cubemap_to_latlong(base, res)
        h, w = res
        y = (torch.arange(h, dtype=torch.float32, device=img.device) + 0.5) / h
        pdf = torch.amax(img, dim=-1) * torch.sin(y * math.pi)[:, None]
        pdf = torch.clamp(pdf, min=1e-6)
        pdf = pdf / pdf.sum()
        cols = torch.cumsum(pdf, dim=1)
        rows = torch.cumsum(cols[:, -1], dim=0)
        cols = cols / torch.clamp(cols[:, -1:], min=1e-12)
        rows = rows / torch.clamp(rows[-1], min=1e-12)
        return {"pdf": pdf,
                "rows": torch.cat([rows.new_zeros(1), rows]),
                "cols": torch.cat([cols.new_zeros((h, 1)), cols], dim=1)}

    def sample(self, pdf_state, num_samples: Optional[int] = None,
               generator: Optional[torch.Generator] = None, uniforms=None):
        """[N, 3] directions importance-sampled from ``pdf_state``, from
        ``uniforms`` (u_row [N], u_col [N]) or ``num_samples`` pairs drawn
        from ``generator``; y-up, as ``cubemap_to_latlong`` lays the
        image out."""
        h, w = pdf_state["pdf"].shape
        rows, cols = pdf_state["rows"], pdf_state["cols"]
        if uniforms is None:
            uniforms = (torch.rand(num_samples, generator=generator,
                                   device=rows.device),
                        torch.rand(num_samples, generator=generator,
                                   device=rows.device))
        u1, u2 = uniforms
        ri = torch.clamp(torch.searchsorted(rows, u1, right=True) - 1, 0,
                         h - 1)
        rfrac = (u1 - rows[ri]) / torch.clamp(rows[ri + 1] - rows[ri],
                                              min=1e-12)
        crow = cols[ri]
        ci = torch.clamp(torch.searchsorted(crow, u2[:, None],
                                            right=True)[:, 0] - 1, 0, w - 1)
        c0 = torch.gather(crow, 1, ci[:, None])[:, 0]
        c1 = torch.gather(crow, 1, ci[:, None] + 1)[:, 0]
        cfrac = (u2 - c0) / torch.clamp(c1 - c0, min=1e-12)
        theta = (ri + rfrac) / h * math.pi
        phi = (ci + cfrac) / w * 2 * math.pi - math.pi
        st, ct = torch.sin(theta), torch.cos(theta)
        return torch.stack([st * torch.sin(phi), ct, -st * torch.cos(phi)], -1)

    def sample_stratified(self, batch_size: int, n_rows: int, n_cols: int,
                          jitter: bool = True,
                          generator: Optional[torch.Generator] = None,
                          uniforms=None):
        """(dirs [B * H * W, 3], inv_pdf [B * H * W, 1]): a lat-long grid
        of ``n_rows`` x ``n_cols`` cells per batch element, each jittered
        within its cell when ``jitter`` by ``uniforms`` (u_phi, u_theta,
        each [B, H, W]) or by draws from ``generator`` (none of the two:
        the cells' centres), on the base's device."""
        device = self.base.device
        lat_step = math.pi / n_rows
        lng_step = 2 * math.pi / n_cols
        theta = torch.linspace(math.pi / 2 - 0.5 * lat_step,
                               -math.pi / 2 + 0.5 * lat_step, n_rows,
                               device=device)
        phi = torch.linspace(math.pi - 0.5 * lng_step,
                             -math.pi + 0.5 * lng_step, n_cols, device=device)
        theta, phi = torch.meshgrid(theta, phi, indexing="ij")
        sin_t = torch.sin(math.pi / 2 - theta)
        inv_pdf = (4 * math.pi * sin_t / torch.sum(sin_t))[None].expand(
            batch_size, n_rows, n_cols)
        if jitter and uniforms is None and generator is not None:
            shape = (batch_size, n_rows, n_cols)
            uniforms = (torch.rand(shape, generator=generator, device=device),
                        torch.rand(shape, generator=generator, device=device))
        if jitter and uniforms is not None:
            phi = phi[None] + lng_step * (uniforms[0] - 0.5)
            theta = theta[None] + lat_step * (uniforms[1] - 0.5)
        else:
            theta = theta[None].expand(batch_size, n_rows, n_cols)
            phi = phi[None].expand(batch_size, n_rows, n_cols)
        dirs = torch.stack([torch.cos(phi) * torch.cos(theta),
                            torch.sin(phi) * torch.cos(theta),
                            torch.sin(theta)], -1)
        dirs = dirs / torch.sqrt(torch.sum(dirs ** 2, -1, keepdim=True)
                                 + 1e-12)
        return dirs.reshape(-1, 3), inv_pdf.reshape(-1, 1)

    def pdf(self, pdf_state, directions):
        """The solid-angle pdf of ``directions`` [..., 3] under the
        lat-long CDFs of ``pdf_state``."""
        h, w = pdf_state["pdf"].shape
        x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
        theta = torch.arccos(torch.clamp(y, -1.0, 1.0))
        phi = torch.atan2(x, -z)
        u = (phi + math.pi) / (2 * math.pi)
        v = theta / math.pi
        ci = torch.clamp((u * w).to(torch.int64), 0, w - 1)
        ri = torch.clamp((v * h).to(torch.int64), 0, h - 1)
        sin_t = torch.clamp(torch.sin(theta), min=1e-6)
        scale = (h * w) / (2 * math.pi * math.pi)
        return pdf_state["pdf"][ri, ci] * scale / sin_t
