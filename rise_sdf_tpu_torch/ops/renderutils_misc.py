"""The rest of nvdiffrec's renderutils (counterpart of
``rise_sdf_tpu/ops/renderutils_misc.py``): shading-normal preparation
(a tangent-space normal map, two-sided flipping, the blend towards the
geometric normal at grazing angles), point and vector transforms, and
the tonemapped HDR image losses.  Nothing in either package calls them
yet.
"""

from __future__ import annotations

import torch

NORMAL_THRESHOLD = 0.1


def _dot(x, y):
    return torch.sum(x * y, -1, keepdim=True)


def _safe_normalize(x, eps=1e-20):
    return x / torch.sqrt(torch.clamp(_dot(x, x), min=eps))


def reflect(x, n):
    return 2.0 * _dot(x, n) * n - x


def _bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading):
    if two_sided_shading:
        flip = _dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(flip, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(flip, geom_nrm, -geom_nrm)
    t = torch.clamp(_dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)


def _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl):
    smooth_bitang = _safe_normalize(torch.linalg.cross(smooth_tng, smooth_nrm,
                                                       dim=-1))
    sign = -1.0 if opengl else 1.0
    shading_nrm = (smooth_tng * perturbed_nrm[..., 0:1]
                   + sign * smooth_bitang * perturbed_nrm[..., 1:2]
                   + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3],
                                              min=0.0))
    return _safe_normalize(shading_nrm)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm,
                           smooth_tng, geom_nrm, two_sided_shading=True,
                           opengl=True):
    """The shading normal: ``perturbed_nrm`` applied in the (tangent,
    bitangent, normal) frame, flipped towards the viewer when
    ``two_sided_shading``, and blended towards ``geom_nrm`` where the
    view grazes the surface."""
    smooth_nrm = _safe_normalize(smooth_nrm)
    smooth_tng = _safe_normalize(smooth_tng)
    view_vec = _safe_normalize(view_pos - pos)
    shading_nrm = _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng,
                                  opengl)
    return _bend_normal(view_vec, shading_nrm, geom_nrm, two_sided_shading)


def xfm_points(points, matrix):
    """[..., N, 3] points by a [..., 4, 4] matrix -> homogeneous
    [..., N, 4]."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    return torch.matmul(torch.cat([points, ones], -1),
                        matrix.transpose(-1, -2))


def xfm_vectors(vectors, matrix):
    """[..., N, 3] vectors by the rotation part of a [..., 4, 4] matrix."""
    return torch.matmul(vectors, matrix[..., :3, :3].transpose(-1, -2))


def _tonemap_srgb(f):
    return torch.where(f > 0.0031308,
                       torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4)
                       * 1.055 - 0.055,
                       12.92 * f)


def image_loss(img, target, loss: str = "l1", tonemapper: str = "none"):
    """A tonemapped HDR image loss: ``loss`` 'mse', 'l1', 'smape' or
    'relmse'; ``tonemapper`` 'none' or 'log_srgb' (log1p of the image
    clamped to [0, 65535], then the sRGB curve)."""
    if tonemapper == "log_srgb":
        img = _tonemap_srgb(torch.log(torch.clamp(img, 0.0, 65535.0) + 1.0))
        target = _tonemap_srgb(torch.log(torch.clamp(target, 0.0, 65535.0)
                                         + 1.0))
    if loss == "mse":
        return torch.mean((img - target) ** 2)
    if loss == "smape":
        return torch.mean(torch.abs(img - target)
                          / (torch.abs(img) + torch.abs(target) + 0.01))
    if loss == "relmse":
        return torch.mean((img - target) ** 2
                          / (img * img + target * target + 0.1))
    return torch.mean(torch.abs(img - target))
