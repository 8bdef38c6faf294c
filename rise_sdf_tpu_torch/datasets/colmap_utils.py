"""COLMAP sparse-reconstruction binary readers in numpy (a copy of
``rise_sdf_tpu/datasets/colmap_utils.py``, itself derived from the
public COLMAP scripts): ``cameras.bin``, ``images.bin`` and
``points3D.bin``, ``qvec2rotmat`` and the RANSAC ground plane, whose
draws come from ``np.random.default_rng(seed)`` as the JAX package's
do, so the same points give the same plane."""

from __future__ import annotations

import collections
import struct

import numpy as np

Camera = collections.namedtuple("Camera", ["id", "model", "width", "height",
                                           "params"])
ImageMeta = collections.namedtuple("ImageMeta", ["id", "qvec", "tvec",
                                                 "camera_id", "name",
                                                 "xys", "point3D_ids"])
Point3D = collections.namedtuple("Point3D", ["id", "xyz", "rgb", "error"])

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(fid, n, fmt):
    return struct.unpack("<" + fmt, fid.read(n))


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            cam_id, model_id, width, height = _read(fid, 24, "iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = _read(fid, 8 * num_params, "d" * num_params)
            cameras[cam_id] = Camera(cam_id, name, width, height,
                                     np.asarray(params))
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            vals = _read(fid, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.asarray(vals[1:5])
            tvec = np.asarray(vals[5:8])
            camera_id = vals[8]
            name = b""
            ch = fid.read(1)
            while ch != b"\x00":
                name += ch
                ch = fid.read(1)
            num_points = _read(fid, 8, "Q")[0]
            data = fid.read(24 * num_points)
            arr = np.frombuffer(data, dtype=np.float64).reshape(num_points, 3)
            xys = arr[:, :2].copy()
            ids = np.frombuffer(data, dtype=np.int64).reshape(
                num_points, 3)[:, 2].copy()
            images[image_id] = ImageMeta(image_id, qvec, tvec, camera_id,
                                         name.decode(), xys, ids)
    return images


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as fid:
        num = _read(fid, 8, "Q")[0]
        for _ in range(num):
            vals = _read(fid, 43, "QdddBBBd")
            pid = vals[0]
            xyz = np.asarray(vals[1:4])
            rgb = np.asarray(vals[4:7])
            error = vals[7]
            track_len = _read(fid, 8, "Q")[0]
            fid.read(8 * track_len)
            points[pid] = Point3D(pid, xyz, rgb, error)
    return points


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y],
    ])


def ransac_plane(pts: np.ndarray, thresh: float = 0.01, iters: int = 512,
                 seed: int = 0):
    """[A,B,C,D] plane of best RANSAC fit (replaces pyransac3d)."""
    rng = np.random.default_rng(seed)
    best_eq, best_count = None, -1
    n = len(pts)
    for _ in range(iters):
        idx = rng.choice(n, 3, replace=False)
        p0, p1, p2 = pts[idx]
        normal = np.cross(p1 - p0, p2 - p0)
        nn = np.linalg.norm(normal)
        if nn < 1e-12:
            continue
        normal = normal / nn
        d = -normal @ p0
        dist = np.abs(pts @ normal + d)
        count = int((dist < thresh).sum())
        if count > best_count:
            best_count = count
            best_eq = np.array([*normal, d])
    return best_eq
