"""Procedural glossy-sphere scene (numpy; counterpart of the sphere scene
in ``rise_sdf_tpu/datasets/synthetic.py``).

Ray-traces a sphere with spatially-varying albedo under an analytic
environment, so training runs with no data files.  The arithmetic is the
JAX package's, step for step, so the images are bit-identical.

Every split keeps the albedo, roughness and normal maps.  With
``relight_list`` the test split also renders the scene under each named
analytic environment (``warm``, ``bright``) as relighting ground truth
and writes that environment as a Blender lat-long EXR under
``hdr_filepath`` (overwritten every time), where the emitter's
``relight_params`` loads it.
"""

from __future__ import annotations

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


def write_env_latlong_exr(path: str, env_fn, height: int = 128):
    """Write an environment function as a Blender-convention lat-long
    EXR (``height`` x 2 ``height``)."""
    h, w = height, 2 * height
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    theta = vv * math.pi
    phi = -(uu * 2.0 - 1.0) * math.pi
    d = np.stack([np.sin(theta) * np.cos(phi),
                  np.sin(theta) * np.sin(phi),
                  np.cos(theta)], -1)
    write_exr(path, env_fn(d).astype(np.float32))


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


class SyntheticSplit:
    def __init__(self, config, split):
        self.config = config
        self.split = split
        w, h = config.get("img_wh", [64, 64])
        self.w, self.h = int(w), int(h)
        self.img_wh = (self.w, self.h)
        n_images = int(config.get("n_images", 8))
        fov = float(config.get("fov", 0.35))  # the sphere fills the frame
        self.focal = 0.5 * self.w / math.tan(0.5 * fov)
        self.directions = get_ray_directions(
            self.w, self.h, self.focal, self.focal, self.w // 2, self.h // 2)
        seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
        self.all_c2w = camera_poses(
            n_images, seed=seed, phase=float(config.get("pose_phase", 0.0)))
        self.env_name = str(config.get("env", "default"))
        views = [render_image(c2w, self.directions,
                              env_fn=_ENVS[self.env_name])
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
                    render_image(c2w, self.directions, env_fn=env_fn)[0]
                    for c2w in self.all_c2w])

    def __len__(self):
        return len(self.all_images)


@register("synthetic-sphere")
class SyntheticDataModule:
    def __init__(self, config):
        self.config = config

    def split(self, name):
        return SyntheticSplit(self.config, name)

    def train(self):
        return self.split("train")

    def val(self):
        return self.split("val")

    def test(self):
        return self.split("test")
