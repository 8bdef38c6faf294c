"""Sampling and BSDF maths for the Monte-Carlo path (counterpart of
``rise_sdf_tpu/ops/warp.py``).

Local frames; hemisphere, disk and cylinder samplers; the SGGX
microflake distribution; isotropic and anisotropic GGX with visible-
normal sampling; Smith masking; Schlick's Fresnel; the analytic BSDF
terms (Lambert, Frostbite, ``pbr_specular``, Phong, ``pbr_bsdf``); and
the spherical-Gaussian helpers.  Everything is elementwise float32 maths
with the JAX package's clamps and floors.  Every sampler takes its
uniforms ``u`` as a tensor; ``gen_stratified_samples`` alone draws its
own numbers, from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _dot(a, b, keepdim=False):
    return torch.sum(a * b, -1, keepdim=keepdim)


def _normalize(v, floor=1e-9):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=floor)


def coordinate_system(n):
    """An orthonormal frame (t, b) around the normal ``n`` [..., 3]
    (Duff et al.'s branchless basis)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b,
                     -sign * n[..., 0]], -1)
    bt = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t, bt


def to_local(v, n):
    t, b = coordinate_system(n)
    return torch.stack([_dot(v, t), _dot(v, b), _dot(v, n)], -1)


def to_world(v, n):
    t, b = coordinate_system(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def square_to_cosine_hemisphere(u):
    """``u`` in [0, 1)^2 -> a cosine-weighted direction about local +z."""
    r = torch.sqrt(u[..., 0])
    phi = 2 * math.pi * u[..., 1]
    z = torch.sqrt(torch.clamp(1 - u[..., 0], 0.0, 1.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


# --------------------------------------------------------------------- #
# Basic samplers
# --------------------------------------------------------------------- #


def gen_stratified_samples(generator: Optional[torch.Generator],
                           batch_size: int, n_rows: int, n_cols: int,
                           is_training: bool = True, device=None):
    """[batch_size * n_rows * n_cols, 2] samples in [0, 1)^2, one per
    (row, column) stratum and batch element: jittered by ``generator``
    when training, the strata's centres otherwise."""
    dx, dy = 1.0 / n_cols, 1.0 / n_rows
    jj = torch.arange(n_cols, dtype=torch.float32, device=device)[None, None]
    ii = torch.arange(n_rows, dtype=torch.float32, device=device)[None, :,
                                                                 None]
    if is_training:
        off = torch.rand((2, batch_size, n_rows, n_cols), generator=generator,
                         device=device)
        off_x, off_y = off[0] * dx, off[1] * dy
    else:
        off_x = torch.full((batch_size, n_rows, n_cols), 0.5 * dx,
                           device=device)
        off_y = torch.full((batch_size, n_rows, n_cols), 0.5 * dy,
                           device=device)
    x = (jj * dx + off_x).reshape(-1)
    y = (ii * dy + off_y).reshape(-1)
    return torch.stack([x, y], -1)


def sample_uniform_disk_concentric(u):
    """[0, 1)^2 -> the unit disk by the concentric map (PBRT 13.6.2)."""
    off = 2.0 * u - 1.0
    ox, oy = off[..., 0], off[..., 1]
    ax, ay = ox.abs(), oy.abs()

    def safe(num, den):
        return num / torch.where(den.abs() > 0, den, 1.0)

    major = ax > ay
    r = torch.where(major, ox, oy)
    theta = torch.where(major, math.pi / 4.0 * safe(oy, ox),
                        math.pi / 2.0 - math.pi / 4.0 * safe(ox, oy))
    r = torch.where((ax == 0) & (ay == 0), 0.0, r)
    return r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)],
                                      -1)


def sample_uniform_cylinder(u):
    """[0, 1)^2 -> a uniform point on the unit cylinder's side."""
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([torch.cos(phi), torch.sin(phi), u[..., 0] * 2.0 - 1.0],
                       -1)


def sample_uniform_hemisphere(u, n):
    """[0, 1)^2 -> a uniform direction on the hemisphere about ``n``."""
    cyl = sample_uniform_cylinder(u)
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return to_world(torch.stack([cyl[..., 0] * r, cyl[..., 1] * r, z], -1),
                    n)


def eval_uniform_hemisphere(wo, n):
    one = torch.full_like(wo[..., 0], 0.5 / math.pi)
    return torch.where(_dot(wo, n) >= 0.0, one, 0.0)


def sample_lambertian_surface(u, n):
    """A cosine-weighted direction about ``n`` through the concentric
    disk."""
    d = sample_uniform_disk_concentric(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2,
                               min=0.0))
    return to_world(torch.stack([d[..., 0], d[..., 1], z], -1), n)


def eval_lambertian_surface(wo, n):
    return torch.relu(_dot(n, wo)) / math.pi


def sample_specular_mirror(u, n, wi, alpha=None):
    """The perfect mirror reflection of ``wi`` about ``n`` (``u`` and
    ``alpha`` unused)."""
    return -wi + 2.0 * n * _dot(n, wi, keepdim=True)


# --------------------------------------------------------------------- #
# SGGX microflake distribution (Heitz et al. 2015): the isotropic
# surface-like S = diag(a^2, a^2, 1) in the (t, b, n) frame
# --------------------------------------------------------------------- #


def _sggx_dots(v, t, b, n):
    return _dot(v, t), _dot(v, b), _dot(v, n)


def sample_sggx_vndf(u, n, wi, alpha):
    """A visible microflake normal of the SGGX distribution."""
    r = torch.sqrt(u[..., 0])
    phi = 2 * math.pi * u[..., 1]
    pu = r * torch.cos(phi)
    pv = r * torch.sin(phi)
    pw = torch.sqrt(torch.clamp(1.0 - pu ** 2 - pv ** 2, min=0.0))

    wk, wj = coordinate_system(wi)
    t, b = coordinate_system(n)
    rough = alpha * alpha
    kt, kb, kn = _sggx_dots(wk, t, b, n)
    jt, jb, jn = _sggx_dots(wj, t, b, n)
    it_, ib, in_ = _sggx_dots(wi, t, b, n)

    s_kk = rough * (kt * kt + kb * kb) + kn * kn
    s_kj = rough * (kt * jt + kb * jb) + kn * jn
    s_ki = rough * (kt * it_ + kb * ib) + kn * in_
    s_jj = rough * (jt * jt + jb * jb) + jn * jn
    s_ji = rough * (jt * it_ + jb * ib) + jn * in_
    s_ii = rough * (it_ * it_ + ib * ib) + in_ * in_

    sqrt_det = torch.sqrt(torch.abs(
        s_kk * s_jj * s_ii - s_kj * s_kj * s_ii - s_ki * s_ki * s_jj
        - s_ji * s_ji * s_kk + 2.0 * s_kj * s_ki * s_ji))
    eps = 1e-6
    inv_sqrt_sii = 1.0 / (torch.sqrt(torch.clamp(s_ii, min=0.0)) + eps)
    tmp = torch.sqrt(torch.clamp(s_jj * s_ii - s_ji * s_ji, min=0.0))
    inv_tmp = 1.0 / (tmp + eps)
    zeros = torch.zeros_like(tmp)
    mk = torch.stack([sqrt_det * inv_tmp, zeros, zeros], -1)
    mj = torch.stack([-inv_sqrt_sii * (s_ki * s_ji - s_kj * s_ii) * inv_tmp,
                      inv_sqrt_sii * tmp, zeros], -1)
    mi = torch.stack([inv_sqrt_sii * s_ki, inv_sqrt_sii * s_ji,
                      inv_sqrt_sii * s_ii], -1)
    wm_kji = _normalize(pu[..., None] * mk + pv[..., None] * mj
                        + pw[..., None] * mi)
    ret = (wm_kji[..., 0:1] * wk + wm_kji[..., 1:2] * wj
           + wm_kji[..., 2:3] * wi) + 1e-6
    return _normalize(ret)


def eval_sggx_ndf(wo, n, alpha):
    """The SGGX NDF D(wm) of the isotropic surface-like S."""
    rough = alpha ** 2
    t, b = coordinate_system(n)
    ot, ob, on = _sggx_dots(wo, t, b, n)
    m2 = ((ot ** 2 + ob ** 2) / rough + on ** 2) ** 2
    eps = 1e-6
    return torch.where(m2 > eps, 1.0 / (math.pi * rough * (m2 + eps)), 0.0)


def eval_sggx_vndf(wo, n, wi, alpha):
    """The SGGX visible-NDF pdf D_wi(wm = wo)."""
    rough = alpha ** 2
    t, b = coordinate_system(n)
    it_, ib, in_ = _sggx_dots(wi, t, b, n)
    sigma = torch.sqrt(torch.clamp(rough * (it_ ** 2 + ib ** 2) + in_ ** 2,
                                   min=0.0))
    d_wm = eval_sggx_ndf(wo, n, alpha)
    dot = torch.clamp(_dot(wi, wo), 0.0, 1.0)
    eps = 1e-6
    return torch.where(sigma > eps, dot * d_wm / (sigma + eps), 0.0)


def sample_diffuse_sggx(u1, u2, n, wi, alpha):
    """The diffuse SGGX phase function: a cosine lobe about a visible
    microflake normal sampled from ``u1`` (held constant for the
    gradient), the lobe sampled from ``u2``."""
    wm = sample_sggx_vndf(u1, n, wi, alpha).detach()
    w1, w2 = coordinate_system(wm)
    d = sample_uniform_disk_concentric(u2)
    x, y = d[..., 0:1], d[..., 1:2]
    z = torch.sqrt(torch.clamp(1.0 - x ** 2 - y ** 2, min=0.0))
    return _normalize(x * w1 + y * w2 + z * wm)


def eval_diffuse_sggx(u, wi, n, wo, alpha):
    """A one-sample estimate of the diffuse-SGGX pdf, differentiable
    through the visible-normal sample."""
    wm = sample_sggx_vndf(u, n, wi, alpha)
    return torch.relu(_dot(wo, wm)) / math.pi


def sample_specular_sggx(u, n, wi, alpha):
    """Specular SGGX: ``wi`` mirrored about a sampled visible normal."""
    wm = sample_sggx_vndf(u, n, wi, alpha).detach()
    return _normalize(-wi + 2.0 * wm * _dot(wm, wi, keepdim=True))


def eval_specular_sggx(wi, n, wo, alpha):
    """The specular SGGX pdf D(wh) / (4 sigma(wi))."""
    rough = alpha ** 2
    wh = _normalize(wi + wo)
    t, b = coordinate_system(n)
    it_, ib, in_ = _sggx_dots(wi, t, b, n)
    sigma = torch.sqrt(torch.clamp(rough * (it_ ** 2 + ib ** 2) + in_ ** 2,
                                   min=0.0))
    eps = 1e-6
    return torch.where(sigma > eps,
                       0.25 * eval_sggx_ndf(wh, n, alpha) / (sigma + eps),
                       0.0)


# --------------------------------------------------------------------- #
# GGX, Smith, Schlick
# --------------------------------------------------------------------- #

SPECULAR_EPS = 1e-4


def fresnel_schlick(f0, cos_theta, f90=1.0):
    """Schlick's Fresnel, the cosine clamped to [eps, 1 - eps]."""
    c = torch.clamp(cos_theta, SPECULAR_EPS, 1.0 - SPECULAR_EPS)
    return f0 + (f90 - f0) * (1.0 - c) ** 5


def eval_ggx_ndf(alpha, cos_theta_h):
    """The GGX NDF (``alpha`` = roughness^2)."""
    c = torch.clamp(cos_theta_h, SPECULAR_EPS, 1.0 - SPECULAR_EPS)
    a2 = alpha * alpha
    d = (c * a2 - c) * c + 1.0
    return a2 / torch.clamp(d * d * math.pi, min=1e-12)


def smith_ggx_g1(alpha, cos_theta):
    c = torch.clamp(cos_theta, 1e-6, 1.0)
    t2 = (1.0 - c * c) / (c * c)
    return 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * t2))


def smith_ggx_lambda(alpha, cos_theta):
    """Smith's Lambda for GGX (``alpha`` = roughness^2)."""
    c = torch.clamp(cos_theta, SPECULAR_EPS, 1.0 - SPECULAR_EPS)
    t2 = (1.0 - c * c) / (c * c)
    return 0.5 * (torch.sqrt(1.0 + (alpha * alpha) * t2) - 1.0)


def smith_ggx_g_correlated(alpha, cos_theta_i, cos_theta_o):
    """Height-correlated Smith masking-shadowing 1 / (1 + Li + Lo)."""
    return 1.0 / (1.0 + smith_ggx_lambda(alpha, cos_theta_i)
                  + smith_ggx_lambda(alpha, cos_theta_o))


def smith_ggx_g1_aniso(v_local, alpha_x, alpha_y):
    """Anisotropic Smith G1 in the local shading frame."""
    c2 = v_local[..., 2] ** 2
    eps = 1e-6
    delta = torch.where(
        c2 > eps,
        -0.5 + 0.5 * torch.sqrt(
            1.0 + ((v_local[..., 0] * alpha_x) ** 2
                   + (v_local[..., 1] * alpha_y) ** 2) / (c2 + eps)),
        0.0)
    return 1.0 / (1.0 + delta)


def smith_ggx_g1_schlick(v_local, k):
    """Schlick's G1 with the remapped roughness ``k``."""
    nom = v_local[..., 2]
    denom = nom * (1.0 - k) + k
    eps = 1e-6
    return torch.where(denom > eps, nom / (denom + eps), 0.0)


def eval_ggx_ndf_aniso(wh_local, alpha_x, alpha_y, eps=1e-6):
    """The anisotropic GGX NDF of a local-frame half vector."""
    denom = (wh_local[..., 0] ** 2 / (alpha_x * alpha_x)
             + wh_local[..., 1] ** 2 / (alpha_y * alpha_y)
             + wh_local[..., 2] ** 2)
    return 1.0 / (math.pi * alpha_x * alpha_y * (denom + eps) ** 2)


def eval_ggx_vndf_local(wh_local, wi_local, alpha_x, alpha_y, eps=1e-6):
    """The GGX VNDF pdf in the local frame (Schlick-G1 form)."""
    k = (alpha_x ** 2 + 2 * alpha_x + 1) / 8.0
    val = (smith_ggx_g1_schlick(wi_local, k)
           * torch.clamp(_dot(wh_local, wi_local), min=0.0)
           * eval_ggx_ndf_aniso(wh_local, alpha_x, alpha_y)
           / (wi_local[..., 2] + eps))
    return torch.where((wh_local[..., 2] > eps) & (wi_local[..., 2] > eps),
                       val, 0.0)


def sample_ggx_vndf(wi_local, alpha, u):
    """Visible-normal GGX sampling (Heitz 2018): ``wi_local`` [..., 3],
    ``alpha`` [...], ``u`` [..., 2] -> a local half vector."""
    vh = _normalize(torch.stack([alpha * wi_local[..., 0],
                                 alpha * wi_local[..., 1],
                                 wi_local[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-12))
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype,
                          device=vh.device).expand_as(vh)
    t1 = torch.where(lensq[..., None] > 1e-7,
                     torch.stack([-vh[..., 1], vh[..., 0],
                                  torch.zeros_like(vh[..., 0])], -1)
                     * inv[..., None], x_axis)
    t2 = torch.linalg.cross(vh, t1, dim=-1)
    r = torch.sqrt(u[..., 0])
    phi = 2 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 ** 2, 0.0, 1.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 ** 2 - p2 ** 2, 0.0, 1.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return _normalize(torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                                   torch.clamp(nh[..., 2], min=0.0)], -1))


def eval_ggx_vndf_pdf(wi_local, h_local, alpha):
    """The pdf of ``sample_ggx_vndf`` in half-vector space."""
    g1 = smith_ggx_g1(alpha, wi_local[..., 2])
    d = eval_ggx_ndf(alpha, h_local[..., 2])
    return g1 * d * torch.clamp(_dot(wi_local, h_local), min=0.0) \
        / torch.clamp(wi_local[..., 2], min=1e-6)


# --------------------------------------------------------------------- #
# Analytic BSDF terms (nvdiffrec's renderutils oracles)
# --------------------------------------------------------------------- #


def _nrmz(v):
    return v / torch.sqrt(_dot(v, v, keepdim=True) + 1e-20)


def lambert(nrm, wi):
    """Lambert's diffuse term max(n . wi, 0) / pi."""
    return torch.clamp(_dot(nrm, wi, keepdim=True), min=0.0) / math.pi


def frostbite_diffuse(nrm, wi, wo, linear_roughness):
    """Frostbite's normalised Disney diffuse: light scatter x view
    scatter x energy factor, zero where either side faces away (no
    cosine or 1/pi factor, as the oracle)."""
    wi_dot_n = _dot(nrm, wi, keepdim=True)
    wo_dot_n = _dot(nrm, wo, keepdim=True)
    h = _nrmz(wi + wo)
    wi_dot_h = _dot(wi, h, keepdim=True)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wi_dot_h ** 2 * linear_roughness
    light_scatter = fresnel_schlick(1.0, wi_dot_n, f90=f90)
    view_scatter = fresnel_schlick(1.0, wo_dot_n, f90=f90)
    mask = (wi_dot_n > 0) & (wo_dot_n > 0)
    return torch.where(mask, light_scatter * view_scatter * energy_factor,
                       0.0)


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness=0.08):
    """Cook-Torrance GGX specular with height-correlated Smith masking."""
    alpha = torch.clamp(alpha, min_roughness ** 2, 1.0)
    h = _nrmz(wi + wo)
    wo_dot_n = _dot(wo, nrm, keepdim=True)
    wi_dot_n = _dot(wi, nrm, keepdim=True)
    wo_dot_h = _dot(wo, h, keepdim=True)
    n_dot_h = _dot(nrm, h, keepdim=True)
    a = alpha[..., 0]
    d = eval_ggx_ndf(a, n_dot_h[..., 0])[..., None]
    g = smith_ggx_g_correlated(a, wi_dot_n[..., 0],
                               wo_dot_n[..., 0])[..., None]
    f = fresnel_schlick(col, wo_dot_h)
    res = f * d * g * 0.25 / torch.clamp(wo_dot_n, min=SPECULAR_EPS)
    mask = (wi_dot_n > SPECULAR_EPS) & (wo_dot_n > SPECULAR_EPS)
    return torch.where(mask, res, 0.0)


def phong(nrm, wo, wi, exponent):
    """Normalised Phong specular."""
    refl = 2.0 * _dot(wo, nrm, keepdim=True) * nrm - wo
    dp_r = torch.clamp(_dot(refl, wi, keepdim=True), 0.0, 1.0)
    dp_l = torch.clamp(_dot(nrm, wi, keepdim=True), 0.0, 1.0)
    return (dp_r ** exponent) * dp_l * (exponent + 2) / (2 * math.pi)


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos, min_roughness=0.08,
             bsdf=0):
    """The point-light PBR BSDF: a diffuse term (Lambert for ``bsdf`` 0,
    Frostbite otherwise) plus GGX specular, with the material packed as
    ``arm`` = (specular strength, roughness, metallic)."""
    wo = _nrmz(view_pos - pos)
    wi = _nrmz(light_pos - pos)
    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1 - spec_str)
    kd = kd * (1.0 - metallic)
    if bsdf == 0:
        diffuse = kd * lambert(nrm, wi)
    else:
        diffuse = kd * frostbite_diffuse(nrm, wi, wo, roughness)
    specular = pbr_specular(ks, nrm, wo, wi, roughness * roughness,
                            min_roughness=min_roughness)
    return diffuse + specular


# --------------------------------------------------------------------- #
# Spherical Gaussians
# --------------------------------------------------------------------- #


def compute_energy(lgt_sgs):
    """The total energy of an SG mixture [N, 7] (lobe, lambda, mu)."""
    lam = torch.abs(lgt_sgs[:, 3:4])
    mu = torch.abs(lgt_sgs[:, 4:])
    return mu * 2.0 * math.pi / lam * (1.0 - torch.exp(-2.0 * lam))


def fibonacci_sphere(samples: int = 1) -> np.ndarray:
    """[samples, 3] float64 points spread evenly on the unit sphere."""
    i = np.arange(samples, dtype=np.float64)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    z = 1 - (i / float(samples - 1)) * 2
    radius = np.sqrt(np.clip(1 - z * z, 0, None))
    theta = phi * i
    return np.stack([np.cos(theta) * radius, np.sin(theta) * radius, z], -1)


def eval_sgs(lgt_sgs, viewdirs):
    """An SG mixture [..., K, 7] evaluated at ``viewdirs`` [..., 3]."""
    v = viewdirs[..., None, :]
    lobes = lgt_sgs[..., :3] / torch.sqrt(
        torch.sum(lgt_sgs[..., :3] ** 2, -1, keepdim=True) + 1e-12)
    lam = torch.abs(lgt_sgs[..., 3:4])
    mu = torch.abs(lgt_sgs[..., -3:])
    lo = mu * torch.exp(lam * (torch.sum(v * lobes, -1, keepdim=True) - 1.0))
    return torch.sum(lo, dim=-2)
