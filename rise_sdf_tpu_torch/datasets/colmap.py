"""COLMAP real-capture loader (counterpart of
``rise_sdf_tpu/datasets/colmap.py``), in numpy.

A capture is ``images/<name>``, optional ``masks/<name>`` (or the name
without its first three characters), and COLMAP's sparse model
``sparse/0/{cameras,images,points3D}.bin``.  Poses go from COLMAP's
world-to-camera ``qvec``/``tvec`` to OpenGL camera-to-world matrices,
are normalised (center ``camera`` / ``lookat`` / ``point``, up
``camera`` or the RANSAC ``ground`` plane, the nearest camera at
distance 1) and split every ``hold_every``-th view to test; ``predict``
is a spheric trajectory of ``n_test_traj_steps`` poses.

Images are read as PIL's ``Image.open(p).convert("RGB")`` and masks as
``.convert("L")`` give them, then resized as ``Image.resize(wh,
Image.BICUBIC)`` (``utils/image.py``).  PNG (``utils/png.py``) and
baseline JPEG (``utils/jpeg.py``) are read, told apart by their first
bytes; any other file raises ``ValueError``.  Where the JAX loader reads every image for each split
and keeps the split's, this one reads only the split's (none for
``predict``), and the data module builds each split once.
"""

from __future__ import annotations

import math
import os

import numpy as np

from . import register
from .colmap_utils import (
    qvec2rotmat,
    ransac_plane,
    read_cameras_binary,
    read_images_binary,
    read_points3d_binary,
)
from ..utils.image import resize_like_pil
from ..utils.jpeg import SIGNATURE as JPEG_SIGNATURE, read_jpeg
from ..utils.png import read_png
from ..utils.rays import get_ray_directions

_PNG = b"\x89PNG\r\n\x1a\n"


def _normalize(v, axis=-1):
    return v / np.maximum(np.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


def get_center(pts: np.ndarray) -> np.ndarray:
    """Mean of the points left after trimming the distances to the mean
    by 1.5 standard deviations and by 1.5 interquartile ranges."""
    center = pts.mean(0)
    dis = np.linalg.norm(pts - center[None], axis=-1)
    mean, std = dis.mean(), dis.std()
    q25, q75 = np.quantile(dis, 0.25), np.quantile(dis, 0.75)
    valid = ((dis > mean - 1.5 * std) & (dis < mean + 1.5 * std)
             & (dis > mean - (q75 - q25) * 1.5)
             & (dis < mean + (q75 - q25) * 1.5))
    return pts[valid].mean(0)


def normalize_poses(poses, pts, up_est_method="camera",
                    center_est_method="camera"):
    """[N, 3, 4] camera-to-world poses and [P, 3] points -> both in the
    normalised frame (float32): the estimated up along +z, the center at
    the origin, the nearest camera at distance 1."""
    if center_est_method in ("camera", "point"):
        center = poses[..., 3].mean(0)
    elif center_est_method == "lookat":
        # the mean of the closest points between each camera's axis and
        # the previous camera's
        cams_ori = poses[..., 3]
        cams_dir = _normalize(poses[:, :3, :3] @ np.array([0.0, 0.0, -1.0]))
        rolled_dir = np.roll(cams_dir, 1, axis=0)
        rolled_ori = np.roll(cams_ori, 1, axis=0)
        a = np.stack([cams_dir, -rolled_dir], axis=-1)
        b = -cams_ori + rolled_ori
        t = np.stack([np.linalg.lstsq(a[i], b[i], rcond=None)[0]
                      for i in range(len(a))])
        pts_a = cams_ori + cams_dir * t[:, 0:1]
        pts_b = rolled_ori + rolled_dir * t[:, 1:2]
        center = np.concatenate([pts_a, pts_b], 0).mean(0)
    else:
        raise NotImplementedError(center_est_method)

    if up_est_method == "ground":
        plane_eq = ransac_plane(pts, thresh=0.01)
        z = _normalize(plane_eq[:3], axis=0)
        signed = (np.concatenate([pts, np.ones_like(pts[:, :1])], -1)
                  * plane_eq).sum(-1)
        if signed.mean() < 0:
            z = -z
    elif up_est_method == "camera":
        z = _normalize((poses[..., 3] - center).mean(0), axis=0)
    else:
        raise NotImplementedError(up_est_method)

    y_ = np.array([z[1], -z[0], 0.0])
    x = _normalize(np.cross(y_, z), axis=0)
    y = np.cross(z, x)

    n = poses.shape[0]
    poses_homo = np.concatenate(
        [poses, np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]]), (n, 1, 1))], 1)

    rc = np.stack([x, y, z], axis=1)
    inv = np.eye(4)
    inv[:3, :3] = rc.T
    if center_est_method == "point":
        # rotate, then center on the points inside the cameras' xy range
        poses_norm = (inv @ poses_homo)[:, :3]
        pts = (inv[:3, :3] @ pts.T).T
        pmin = poses_norm[..., 3].min(0)
        pmax = poses_norm[..., 3].max(0)
        fg = pts[(pmin[0] < pts[:, 0]) & (pts[:, 0] < pmax[0])
                 & (pmin[1] < pts[:, 1]) & (pts[:, 1] < pmax[1])]
        center = get_center(fg if len(fg) else pts)
        poses_norm[..., 3] -= center
        pts = pts - center
        scale = np.linalg.norm(poses_norm[..., 3], axis=-1).min()
        poses_norm[..., 3] /= scale
        pts = pts / scale
    else:
        inv[:3, 3] = (-rc.T @ center.reshape(3, 1))[:, 0]
        poses_norm = (inv @ poses_homo)[:, :3]
        scale = np.linalg.norm(poses_norm[..., 3], axis=-1).min()
        poses_norm[..., 3] /= scale
        pts = (inv[:3, :3] @ pts.T).T + inv[:3, 3]
        pts = pts / scale
    return poses_norm.astype(np.float32), pts.astype(np.float32)


def create_spheric_poses(cameras: np.ndarray, n_steps=120) -> np.ndarray:
    """[n_steps, 3, 4] poses on a circle at the cameras' mean height and
    horizontal distance, each looking at the origin with +z up."""
    center = np.zeros(3)
    mean_d = np.linalg.norm(cameras - center[None], axis=-1).mean()
    mean_h = cameras[:, 2].mean()
    r = math.sqrt(max(mean_d ** 2 - mean_h ** 2, 1e-6))
    up = np.array([0.0, 0.0, 1.0])
    out = []
    for theta in np.linspace(0, 2 * math.pi, n_steps):
        cam_pos = np.array([r * math.cos(theta), r * math.sin(theta), mean_h])
        l = _normalize(center - cam_pos, axis=0)
        s = _normalize(np.cross(l, up), axis=0)
        u = _normalize(np.cross(s, l), axis=0)
        c2w = np.concatenate([np.stack([s, u, -l], 1), cam_pos[:, None]], 1)
        out.append(c2w)
    return np.stack(out).astype(np.float32)


def _read(path: str) -> np.ndarray:
    """A PNG or JPEG as uint8 [H, W, C]; ``ValueError`` for any other
    file."""
    with open(path, "rb") as f:
        head = f.read(len(_PNG))
    if head == _PNG:
        return read_png(path)
    if head.startswith(JPEG_SIGNATURE):
        return read_jpeg(path)
    raise ValueError(f"{path}: the colmap loader reads PNG and JPEG "
                     "images only")


def to_rgb(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> [H, W, 3] as PIL's ``convert("RGB")``: grey is
    repeated, alpha dropped (not composited)."""
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def to_grey(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> [H, W, 1] as PIL's ``convert("L")``: alpha
    dropped, colour weighted (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    if img.shape[-1] in (1, 2):
        return img[..., :1].copy()
    c = img[..., :3].astype(np.uint32)
    lum = (c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
           + 0x8000) >> 16
    return lum.astype(np.uint8)[..., None]


class ColmapSplit:
    def __init__(self, config, split):
        self.config = config
        self.split = split
        hold_every = int(config.get("hold_every", 8))
        root = config["root_dir"]
        camdata = read_cameras_binary(os.path.join(root,
                                                   "sparse/0/cameras.bin"))
        cam = camdata[min(camdata.keys())]
        H, W = int(cam.height), int(cam.width)
        if "img_wh" in config:
            w, h = config["img_wh"]
            if round(W / w * h) != H:
                raise ValueError(f"img_wh {w}x{h} does not keep the aspect "
                                 f"of the {W}x{H} images")
        elif "img_downscale" in config:
            w = int(W / config["img_downscale"] + 0.5)
            h = int(H / config["img_downscale"] + 0.5)
        else:
            raise KeyError("Either img_wh or img_downscale must be specified")
        self.w, self.h = int(w), int(h)
        self.img_wh = (self.w, self.h)
        factor = w / W
        if cam.model in ("SIMPLE_RADIAL", "SIMPLE_PINHOLE"):
            fx = fy = cam.params[0] * factor
            cx, cy = cam.params[1] * factor, cam.params[2] * factor
        elif cam.model in ("PINHOLE", "OPENCV"):
            fx, fy = cam.params[0] * factor, cam.params[1] * factor
            cx, cy = cam.params[2] * factor, cam.params[3] * factor
        else:
            raise ValueError(f"Unsupported camera model {cam.model}")
        self.directions = get_ray_directions(self.w, self.h, fx, fy, cx, cy)
        self.near = float(config.get("near_plane", 0.1))
        self.far = float(config.get("far_plane", 1e3))

        imdata = read_images_binary(os.path.join(root,
                                                 "sparse/0/images.bin"))
        mask_dir = os.path.join(root, "masks")
        self.has_mask = os.path.isdir(mask_dir)
        self.apply_mask = self.has_mask and bool(config.get("apply_mask",
                                                            True))
        n = len(imdata)
        if split == "predict":
            idx = []
        elif split in ("train", "val"):
            idx = [i for i in range(n) if i % hold_every != 0]
        else:
            idx = [i for i in range(n) if i % hold_every == 0]

        c2ws, images, masks = [], [], []
        for i, d in enumerate(imdata.values()):
            r = qvec2rotmat(d.qvec)
            t = d.tvec.reshape(3, 1)
            c2w = np.concatenate([r.T, -r.T @ t], axis=1).astype(np.float32)
            c2w[:, 1:3] *= -1.0  # COLMAP -> OpenGL
            c2ws.append(c2w)
            if i not in idx:
                continue
            img = resize_like_pil(
                to_rgb(_read(os.path.join(root, "images", d.name))),
                self.img_wh)
            images.append(img.astype(np.float32) / 255.0)
            if not self.has_mask:
                masks.append(np.ones((self.h, self.w), np.float32))
                continue
            paths = [os.path.join(mask_dir, d.name),
                     os.path.join(mask_dir, d.name[3:])]
            path = next((p for p in paths if os.path.exists(p)), None)
            if path is None:
                raise FileNotFoundError(f"no mask for {d.name} under "
                                        f"{mask_dir}")
            m = resize_like_pil(to_grey(_read(path)), self.img_wh)
            masks.append(m[..., 0].astype(np.float32) / 255.0)

        all_c2w = np.stack(c2ws)
        pts3d_map = read_points3d_binary(
            os.path.join(root, "sparse/0/points3D.bin"))
        pts3d = np.stack([p.xyz for p in pts3d_map.values()]).astype(
            np.float32)
        all_c2w, self.pts3d = normalize_poses(
            all_c2w, pts3d,
            up_est_method=config.get("up_est_method", "camera"),
            center_est_method=config.get("center_est_method", "camera"))

        if split == "predict":
            steps = int(config.get("n_test_traj_steps", 120))
            self.all_c2w = create_spheric_poses(all_c2w[:, :, 3], steps)
            self.all_images = np.zeros((steps, self.h, self.w, 3),
                                       np.float32)
            self.all_fg_masks = np.zeros((steps, self.h, self.w), np.float32)
        else:
            self.all_c2w = all_c2w[idx]
            self.all_images = np.stack(images)
            self.all_fg_masks = np.stack(masks)

    def __len__(self):
        return len(self.all_images)


@register("colmap")
class ColmapDataModule:
    def __init__(self, config):
        self.config = config
        self._splits = {}

    def split(self, name):
        """The split ``name``, read on first use (a capture's hundreds of
        images are decoded once per run, not at every validation)."""
        if name not in self._splits:
            self._splits[name] = ColmapSplit(self.config, name)
        return self._splits[name]

    def train(self):
        return self.split("train")

    def val(self):
        return self.split(self.config.get("val_split", "train"))

    def test(self):
        return self.split(self.config.get("test_split", "test"))

    def predict(self):
        return self.split("predict")
