"""Artifact saving: image grids (PNG, EXR), arrays and meshes (PLY)
(counterpart of ``rise_sdf_tpu/utils/saving.py``).

The JAX package writes PNGs with cv2; the port writes them itself (8-bit
RGB, every row unfiltered, one zlib stream at level 1, cv2's default
speed) and maps grayscale images through a numpy ``jet`` table, so it
needs neither cv2 nor PIL.  EXR grids go through ``utils/exr.py``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional

import numpy as np

from .exr import write_exr


def _jet_table() -> np.ndarray:
    """[256, 3] uint8: the jet colormap (blue, cyan, yellow, red), each
    channel the piecewise-linear ramp ``clip(1.5 - |4 x - k|, 0, 1)``
    with k = 3 (red), 2 (green), 1 (blue)."""
    x = np.arange(256) / 255.0
    rgb = np.stack([np.clip(1.5 - np.abs(4 * x - k), 0, 1)
                    for k in (3, 2, 1)], -1)
    return np.round(rgb * 255).astype(np.uint8)


JET = _jet_table()


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W, 3] as an RGB PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, not {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], 1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))


class Saver:
    def __init__(self, save_dir: str):
        self.save_dir = save_dir

    def get_save_path(self, filename: str) -> str:
        path = os.path.join(self.save_dir, filename)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    @staticmethod
    def _img_to_u8(spec: dict) -> np.ndarray:
        """One grid cell as uint8 [H, W, 3].  ``rgb``: ``data_range``
        (default (0, 1)) mapped to [0, 1] and clipped.  ``grayscale``:
        ``data_range`` None clips, "auto" (the default) or () stretches
        min..max, a pair maps that range; then ``cmap`` "jet" (the
        default) or gray."""
        img = np.asarray(spec["img"], np.float32)
        kwargs = spec.get("kwargs", {})
        typ = spec["type"]
        if typ == "rgb":
            lo, hi = kwargs.get("data_range", (0, 1))
            img = np.clip((img - lo) / (hi - lo), 0, 1)
            return (img * 255).astype(np.uint8)
        if typ == "grayscale":
            rng = kwargs.get("data_range", "auto")
            if rng is None:
                img = np.clip(img, 0, 1)
            elif isinstance(rng, str) or rng == ():
                lo, hi = float(img.min()), float(img.max())
                img = (img - lo) / max(hi - lo, 1e-8)
            else:
                img = np.clip((img - rng[0]) / (rng[1] - rng[0]), 0, 1)
            u8 = (img * 255).astype(np.uint8)
            if kwargs.get("cmap", "jet") == "jet":
                return JET[u8]
            return np.stack([u8] * 3, -1)
        raise ValueError(f"unknown image type '{typ}'")

    def save_image_grid(self, filename: str, specs: List[dict]) -> str:
        """The images side by side: an 8-bit PNG, or with a ``.exr``
        name float32 (grayscale repeated to RGB)."""
        path = self.get_save_path(filename)
        if filename.endswith(".exr"):
            imgs = [np.asarray(s["img"], np.float32) for s in specs]
            imgs = [i if i.ndim == 3 else i[..., None] for i in imgs]
            imgs = [np.repeat(i, 3, -1) if i.shape[-1] == 1 else i
                    for i in imgs]
            write_exr(path, np.concatenate(imgs, axis=1))
            return path
        imgs = [self._img_to_u8(s) for s in specs]
        h = max(i.shape[0] for i in imgs)
        imgs = [np.pad(i, ((0, h - i.shape[0]), (0, 0), (0, 0)))
                for i in imgs]
        write_png(path, np.concatenate(imgs, axis=1))
        return path

    def save_npy(self, filename: str, arr) -> str:
        path = self.get_save_path(filename)
        np.save(path, np.asarray(arr))
        return path

    def save_mesh(self, filename: str, v_pos, t_pos_idx, v_rgb=None) -> str:
        path = self.get_save_path(filename)
        write_ply(path, np.asarray(v_pos), np.asarray(t_pos_idx),
                  None if v_rgb is None else np.asarray(v_rgb))
        return path


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """Binary little-endian PLY: float32 vertices, optional uchar RGB
    colours (``colors`` in [0, 1]), triangles as uchar-counted int32
    lists."""
    n_v, n_f = len(verts), len(faces)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n_v}",
                  "property float x", "property float y", "property float z"]
        if colors is not None:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [f"element face {n_f}",
                   "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            rec = np.zeros(n_v, dtype=[("v", "<f4", 3), ("c", "u1", 3)])
            rec["v"] = verts.astype(np.float32)
            rec["c"] = np.clip(colors * 255, 0, 255).astype(np.uint8)
            f.write(rec.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        frec = np.zeros(n_f, dtype=[("n", "u1"), ("i", "<i4", 3)])
        frec["n"] = 3
        frec["i"] = faces.astype(np.int32)
        f.write(frec.tobytes())


def load_ply(path: str):
    """(verts [V, 3], faces [F, 3]) of a file ``write_ply`` wrote."""
    with open(path, "rb") as f:
        line = b""
        n_v = n_f = 0
        has_color = False
        while not line.startswith(b"end_header"):
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith(b"element face"):
                n_f = int(line.split()[-1])
            elif line.startswith(b"property uchar red"):
                has_color = True
        vdt = [("v", "<f4", 3)] + ([("c", "u1", 3)] if has_color else [])
        verts = np.frombuffer(f.read(n_v * (15 if has_color else 12)),
                              dtype=vdt)["v"].copy()
        frec = np.frombuffer(f.read(n_f * 13),
                             dtype=[("n", "u1"), ("i", "<i4", 3)])
        return verts, frec["i"].copy()
