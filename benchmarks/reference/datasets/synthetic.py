"""Procedural scenes (numpy; counterpart of
``rise_sdf_tpu/datasets/synthetic.py``): a glossy sphere
(``synthetic-sphere``) and a concave sphere-and-torus union
(``synthetic-concave``).

The sphere is ray-traced with spatially-varying albedo under an analytic
environment, so training runs with no data files.  The concave scene is
sphere-traced against its exact SDF and shaded with one bounce: a
mirror ray that hits the scene sees the blocker's direct shading in
place of the environment, so its images carry the self-occlusion and
inter-reflection that the flagship's secondary pass models.  Its
defaults are a wider field of view (0.42) and the high-contrast
``bright`` environment.  The arithmetic is the JAX package's, step for
step, so the images are bit-identical.

Every split keeps the albedo, roughness and normal maps.  With
``relight_list`` the test split also renders the scene under each named
analytic environment (``warm``, ``bright``) as relighting ground truth
and writes that environment as a Blender lat-long EXR under
``hdr_filepath`` (overwritten every time), where the emitter's
``relight_params`` loads it.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

from . import register
from ..utils.exr import write_exr
from ..utils.rays import get_ray_directions

SPHERE_RADIUS = 0.5


def look_at(eye: np.ndarray) -> np.ndarray:
    """[3,4] c2w, camera -z looks at origin (OpenGL convention)."""
    forward = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 0.0, 1.0])
    if abs(forward @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    return np.stack([right, true_up, -forward, eye], axis=1).astype(np.float32)


def camera_poses(n: int, radius: float = 4.0, seed: int = 0,
                 phase: float = 0.0) -> np.ndarray:
    """``n`` cameras on an azimuth ladder; ``phase`` (in pose-index
    units) rotates it, so phases 0 and 0.5 give 2n distinct views."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        theta = 2 * math.pi * (i + phase) / n
        phi = math.pi / 4 + 0.3 * math.sin(3 * theta) \
            + 0.05 * rng.standard_normal()
        eye = radius * np.array([
            math.cos(theta) * math.sin(phi),
            math.sin(theta) * math.sin(phi),
            math.cos(phi),
        ])
        poses.append(look_at(eye))
    return np.stack(poses)


def env_radiance(d: np.ndarray) -> np.ndarray:
    """Smooth analytic environment light (RGB), d: [...,3] unit."""
    sky = np.array([0.5, 0.6, 0.8]) * (0.5 + 0.5 * d[..., 2:3])
    sun_dir = np.array([0.5, 0.3, 0.8])
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    sun = np.array([1.0, 0.95, 0.8]) * np.maximum(
        (d @ sun_dir), 0.0)[..., None] ** 16 * 2.0
    return (sky + sun).astype(np.float32)


def env_radiance_warm(d: np.ndarray) -> np.ndarray:
    """Alternate analytic environment (warm sunset) for relighting."""
    horizon = np.array([0.9, 0.5, 0.25]) * (1.0 - np.abs(d[..., 2:3])) ** 2
    sky = np.array([0.25, 0.3, 0.5]) * (0.4 + 0.6 * d[..., 2:3])
    sun_dir = np.array([-0.7, 0.2, 0.25])
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    sun = np.array([1.2, 0.7, 0.35]) * np.maximum(
        (d @ sun_dir), 0.0)[..., None] ** 24 * 3.0
    return (horizon + sky + sun).astype(np.float32)


def env_radiance_bright(d: np.ndarray) -> np.ndarray:
    """High-contrast environment (a broad bright sun)."""
    sky = np.array([0.5, 0.6, 0.8]) * (0.5 + 0.5 * d[..., 2:3])
    sun_dir = np.array([0.5, 0.3, 0.8])
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    sun = np.array([1.0, 0.95, 0.8]) * np.maximum(
        (d @ sun_dir), 0.0)[..., None] ** 8 * 6.0
    return (sky + sun).astype(np.float32)


_ENVS = {"default": env_radiance, "warm": env_radiance_warm,
         "bright": env_radiance_bright}


def env_latlong(env_fn, height: int = 128) -> np.ndarray:
    """An environment function as a Blender-convention lat-long image,
    float32 [height, 2 height, 3]."""
    h, w = height, 2 * height
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    theta = vv * math.pi
    phi = -(uu * 2.0 - 1.0) * math.pi
    d = np.stack([np.sin(theta) * np.cos(phi),
                  np.sin(theta) * np.sin(phi),
                  np.cos(theta)], -1)
    return env_fn(d).astype(np.float32)


def write_env_latlong_exr(path: str, env_fn, height: int = 128):
    """Write ``env_latlong(env_fn, height)`` as an EXR."""
    write_exr(path, env_latlong(env_fn, height))


def sphere_albedo(p: np.ndarray) -> np.ndarray:
    """Spatially-varying albedo on the sphere surface."""
    a = 0.5 + 0.5 * np.sin(6.0 * p[..., 0:1])
    b = 0.5 + 0.5 * np.sin(6.0 * p[..., 1:2] + 1.0)
    c = 0.5 + 0.5 * np.cos(6.0 * p[..., 2:3])
    return np.concatenate([0.8 * a, 0.6 * b, 0.7 * c],
                          axis=-1).astype(np.float32)


def render_image(c2w: np.ndarray, directions: np.ndarray,
                 roughness: float = 0.3, metallic: float = 0.5,
                 env_fn=env_radiance):
    """Ray-trace the sphere -> (rgb [H,W,3], mask, albedo, rough, normal)."""
    h, w = directions.shape[:2]
    d = directions @ c2w[:3, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:, 3], d.shape)

    b = np.sum(o * d, -1)
    c = np.sum(o * o, -1) - SPHERE_RADIUS ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = o + t[..., None] * d
    n = p / SPHERE_RADIUS
    alb = sphere_albedo(p)
    wo = -d
    refl = 2 * np.sum(wo * n, -1, keepdims=True) * n - wo
    nov = np.clip(np.sum(n * wo, -1, keepdims=True), 0, 1)
    # crude split-sum-flavored shading: diffuse env + fresnel-weighted mirror
    diff = (1 - metallic) * alb * env_fn(n) * 0.7
    f0 = 0.04 * (1 - metallic) + metallic * alb
    fres = f0 + (1 - f0) * (1 - nov) ** 5
    spec = fres * env_fn(refl)
    rgb_lin = diff + spec
    srgb = np.where(rgb_lin <= 0.0031308, rgb_lin * 12.92,
                    1.055 * np.maximum(rgb_lin, 0.0031308) ** (1 / 2.4)
                    - 0.055)
    srgb = np.clip(srgb, 0, 1)
    mask = hit.astype(np.float32)
    rgb = srgb * mask[..., None] + (1 - mask[..., None])  # white bg
    normal = np.where(hit[..., None], n, np.array([0.0, 0.0, 1.0]))
    albedo = np.where(hit[..., None], alb, 0.0)
    rough = np.full((h, w, 1), roughness, np.float32) * mask[..., None]
    return (rgb.astype(np.float32), mask, albedo.astype(np.float32),
            rough, normal.astype(np.float32))


# The concave scene: a sphere and a torus in the z = 0 plane, metallic
# and glossy (roughness under the model's relighting threshold of 0.3,
# so the third bounce engages).
CONCAVE_SPHERE_R = 0.45
CONCAVE_TORUS_R = 0.63  # major radius
CONCAVE_TORUS_r = 0.17  # minor radius
CONCAVE_ROUGHNESS = 0.12
CONCAVE_METALLIC = 0.95


def concave_sdf(p: np.ndarray) -> np.ndarray:
    """Exact SDF of the sphere and torus union, p: [...,3] -> [...]."""
    sphere = np.linalg.norm(p, axis=-1) - CONCAVE_SPHERE_R
    ring = np.hypot(p[..., 0], p[..., 1]) - CONCAVE_TORUS_R
    torus = np.hypot(ring, p[..., 2]) - CONCAVE_TORUS_r
    return np.minimum(sphere, torus)


def concave_normal(p: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Central-difference SDF normal (robust across the union's seam)."""
    offs = np.eye(3, dtype=p.dtype) * eps
    g = np.stack([concave_sdf(p + offs[i]) - concave_sdf(p - offs[i])
                  for i in range(3)], axis=-1)
    return g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)


def sphere_trace_np(o: np.ndarray, d: np.ndarray, t0: float, t1: float,
                    iters: int = 128, eps: float = 5e-5):
    """Sphere trace of rays (o, d) against ``concave_sdf`` from ``t0``,
    each ray leaving the active set once it hits or passes ``t1``.
    Returns (hit mask, t)."""
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    n = o.shape[0]
    t = np.full(n, t0, np.float64)
    hit = np.zeros(n, bool)
    active = np.arange(n)
    for _ in range(iters):
        if active.size == 0:
            break
        p = o[active] + t[active, None] * d[active]
        s = concave_sdf(p)
        t[active] += np.maximum(s, 0.0) * 0.9 + np.minimum(s, 0.0)
        newly_hit = s < eps
        hit[active[newly_hit]] = True
        escaped = t[active] > t1
        active = active[~(newly_hit | escaped)]
    return hit, t


@functools.lru_cache(maxsize=None)
def _irradiance_table(env_fn, res: int = 24, n_quad: int = 48) -> np.ndarray:
    """Cosine-convolved irradiance (over pi) of ``env_fn`` on a
    ``res`` x 2 ``res`` lat-long grid of normals, by quadrature over a
    lat-long grid of directions."""
    h, w = res, 2 * res
    theta_n = (np.arange(h) + 0.5) / h * math.pi
    phi_n = (np.arange(w) + 0.5) / w * 2 * math.pi
    tt, pp = np.meshgrid(theta_n, phi_n, indexing="ij")
    normals = np.stack([np.sin(tt) * np.cos(pp),
                        np.sin(tt) * np.sin(pp), np.cos(tt)], -1)
    qt = (np.arange(n_quad) + 0.5) / n_quad * math.pi
    qp = (np.arange(2 * n_quad) + 0.5) / (2 * n_quad) * 2 * math.pi
    qtt, qpp = np.meshgrid(qt, qp, indexing="ij")
    dirs = np.stack([np.sin(qtt) * np.cos(qpp),
                     np.sin(qtt) * np.sin(qpp), np.cos(qtt)], -1)
    dirs = dirs.reshape(-1, 3)
    w_solid = (np.sin(qtt).reshape(-1) * (math.pi / n_quad)
               * (math.pi / n_quad))
    rad = env_fn(dirs)  # [Q, 3]
    cosw = np.clip(normals.reshape(-1, 3) @ dirs.T, 0.0, None)  # [N, Q]
    irr = (cosw * w_solid) @ rad / math.pi
    return irr.reshape(h, w, 3).astype(np.float32)


def _irradiance_map(env_fn):
    """``irr(n) -> [..., 3]``: the nearest cell of ``env_fn``'s
    irradiance table (the environments are smooth)."""
    table = _irradiance_table(env_fn)
    h, w = table.shape[:2]

    def lookup(n):
        nz = np.clip(n[..., 2], -1.0, 1.0)
        theta = np.arccos(nz)
        phi = np.arctan2(n[..., 1], n[..., 0]) % (2 * math.pi)
        i = np.clip((theta / math.pi * h).astype(int), 0, h - 1)
        j = np.clip((phi / (2 * math.pi) * w).astype(int), 0, w - 1)
        return table[i, j]

    return lookup


def _shade_direct(p, n, wo, env_fn, irr, roughness, metallic,
                  spec_in=None):
    """Split-sum-flavoured direct shading (linear RGB) of the primary and
    the one-bounce hits.  ``spec_in`` replaces the specular incoming
    radiance (by default the unoccluded environment in the mirror
    direction)."""
    alb = sphere_albedo(p)
    nov = np.clip(np.sum(n * wo, -1, keepdims=True), 0, 1)
    refl = 2 * nov * n - wo
    diff = (1 - metallic) * alb * irr(n)
    f0 = 0.04 * (1 - metallic) + metallic * alb
    fres = f0 + (1 - f0) * (1 - nov) ** 5
    if spec_in is None:
        spec_in = env_fn(refl)
    return diff + fres * spec_in, refl


def render_image_concave(c2w: np.ndarray, directions: np.ndarray,
                         env_fn=env_radiance):
    """One-bounce ground truth of the concave scene -> (rgb [H,W,3], mask,
    albedo, rough, normal), as ``render_image``.  The primary hit is
    shaded split-sum style; its mirror ray is traced against the scene,
    and where it is blocked the specular term sees the blocker's direct
    shading in place of the environment."""
    h, w = directions.shape[:2]
    d = directions @ c2w[:3, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.reshape(-1, 3)
    o = np.broadcast_to(c2w[:, 3], d.shape).astype(np.float64)

    extent = CONCAVE_TORUS_R + CONCAVE_TORUS_r
    dist = np.linalg.norm(c2w[:, 3])
    hit, t = sphere_trace_np(o, d, max(dist - extent - 0.2, 0.0),
                             dist + extent + 0.2)
    p = o + t[:, None] * d
    n = concave_normal(p)
    irr = _irradiance_map(env_fn)

    rgb_lin = np.zeros((h * w, 3), np.float32)
    alb_full = np.zeros((h * w, 3), np.float32)
    nrm_full = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (h * w, 1))
    if hit.any():
        hp, hn, hd = p[hit], n[hit], d[hit]
        wo = -hd
        refl = 2 * np.clip(np.sum(hn * wo, -1, keepdims=True),
                           0, 1) * hn - wo
        # the mirror ray, for occlusion and inter-reflection
        so = hp + 1e-3 * hn
        hit2, t2 = sphere_trace_np(so, refl, 1e-3, 4.0 * extent)
        q = so + t2[:, None] * refl
        spec_in = env_fn(refl.astype(np.float32))
        if hit2.any():
            nq = concave_normal(q[hit2])
            # the blocker shaded by the unoccluded direct model, as the
            # model's third bounce shades it
            blocker_rgb, _ = _shade_direct(
                q[hit2], nq, -refl[hit2], env_fn, irr,
                CONCAVE_ROUGHNESS, CONCAVE_METALLIC)
            spec_in[hit2] = blocker_rgb
        full, _ = _shade_direct(hp, hn, wo, env_fn, irr,
                                CONCAVE_ROUGHNESS, CONCAVE_METALLIC,
                                spec_in=spec_in)
        rgb_lin[hit] = full
        alb_full[hit] = sphere_albedo(hp)
        nrm_full[hit] = hn

    srgb = np.where(rgb_lin <= 0.0031308, rgb_lin * 12.92,
                    1.055 * np.maximum(rgb_lin, 0.0031308) ** (1 / 2.4)
                    - 0.055)
    srgb = np.clip(srgb, 0, 1).reshape(h, w, 3)
    mask = hit.reshape(h, w).astype(np.float32)
    rgb = srgb * mask[..., None] + (1 - mask[..., None])  # white bg
    albedo = alb_full.reshape(h, w, 3)
    rough = (np.full((h, w, 1), CONCAVE_ROUGHNESS, np.float32)
             * mask[..., None])
    normal = nrm_full.reshape(h, w, 3)
    return (rgb.astype(np.float32), mask, albedo.astype(np.float32),
            rough, normal.astype(np.float32))


class SyntheticSplit:
    def __init__(self, config, split):
        self.config = config
        self.split = split
        self.shape = str(config.get("shape", "sphere"))
        concave = self.shape == "concave"
        w, h = config.get("img_wh", [64, 64])
        self.w, self.h = int(w), int(h)
        self.img_wh = (self.w, self.h)
        n_images = int(config.get("n_images", 8))
        # the object fills the frame (the concave scene is wider)
        fov = float(config.get("fov", 0.42 if concave else 0.35))
        self.focal = 0.5 * self.w / math.tan(0.5 * fov)
        self.directions = get_ray_directions(
            self.w, self.h, self.focal, self.focal, self.w // 2, self.h // 2)
        seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
        self.all_c2w = camera_poses(
            n_images, seed=seed, phase=float(config.get("pose_phase", 0.0)))
        render = render_image_concave if concave else render_image
        # the concave scene trains under the high-contrast sun, whose
        # occlusion in mirror directions its ground truth depends on
        self.env_name = str(config.get("env",
                                       "bright" if concave else "default"))
        views = [render(c2w, self.directions, env_fn=_ENVS[self.env_name])
                 for c2w in self.all_c2w]
        (self.all_images, self.all_fg_masks, self.all_albedo,
         self.all_roughness, self.all_normals) = (
            np.stack(v) for v in zip(*views))
        # relighting ground truth, consumed by the test protocol only
        self.relight_images = {}
        relight_list = list(config.get("relight_list", []) or [])
        if relight_list and split == "test":
            hdr_dir = config.get("hdr_filepath")
            if not hdr_dir:
                raise ValueError("relight_list needs hdr_filepath, the "
                                 "directory of the environment EXRs")
            os.makedirs(hdr_dir, exist_ok=True)
            for light in relight_list:
                env_fn = _ENVS[light]
                # always overwrite: a stale file would skew the relight
                # metrics against ground truth rendered anew
                write_env_latlong_exr(os.path.join(hdr_dir, f"{light}.exr"),
                                      env_fn)
                self.relight_images[light] = np.stack([
                    render(c2w, self.directions, env_fn=env_fn)[0]
                    for c2w in self.all_c2w])

    def __len__(self):
        return len(self.all_images)


@register("synthetic-sphere")
class SyntheticDataModule:
    def __init__(self, config):
        self.config = config
        self._splits = {}

    def split(self, name):
        """The split ``name``, rendered on first use (every ``fit`` and
        validation reads it again)."""
        if name not in self._splits:
            self._splits[name] = SyntheticSplit(self.config, name)
        return self._splits[name]

    def train(self):
        return self.split("train")

    def val(self):
        return self.split("val")

    def test(self):
        return self.split("test")


@register("synthetic-concave")
class ConcaveDataModule(SyntheticDataModule):
    """The sphere and torus union: self-occlusion and inter-reflection
    that the convex sphere cannot show."""

    def __init__(self, config):
        super().__init__(dict(config, shape="concave"))
