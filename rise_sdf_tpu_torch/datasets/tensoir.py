"""TensoIR-synthetic scene loader (counterpart of
``rise_sdf_tpu/datasets/tensoir.py``).

Per-frame directories ``{split}_NNN/`` with ``metadata.json``
(``cam_transform_mat``, ``cam_angle_x``), ``rgba.png``, optional
``albedo.exr|png`` and ``roughness.exr|png``, ``normal.exr``
(composited over a +z background by its alpha, then normalized), and the
relighting ground truth ``rgba_{light}.png`` per entry of
``relight_list``.  PNGs go through ``utils/png.py`` and PIL's bicubic
resize (``utils/image.py``), EXRs through ``utils/exr.py``; the arrays
stay on the host.

Two quirks of the reference are kept as they are: an EXR is not resized
when ``img_wh`` differs from the file's size, and a png roughness is
read from ``roughness.{roughness_format}`` (the "clean" behaviour the
reference's docstring describes).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from . import register
from ..utils.exr import read_exr
from ..utils.image import read_image
from ..utils.rays import get_ray_directions


def image_size(config, w_file: int, h_file: int):
    """(w, h) from ``img_wh`` or ``img_downscale``, as the reference."""
    if "img_wh" in config:
        w, h = config["img_wh"]
        if round(w_file / w * h) != h_file:
            raise ValueError(f"img_wh {w}x{h} does not keep the aspect "
                             f"of the {w_file}x{h_file} images")
    elif "img_downscale" in config:
        w, h = (w_file // config["img_downscale"],
                h_file // config["img_downscale"])
    else:
        raise KeyError("Either img_wh or img_downscale must be specified")
    return int(w), int(h)


class TensoIRSplit:
    def __init__(self, config, split):
        self.config = config
        self.split = split
        self.has_mask = True
        self.apply_mask = True

        root = Path(config["root_dir"])
        split_list = sorted(x for x in root.iterdir()
                            if x.stem.startswith(split))
        if not split_list:
            raise FileNotFoundError(f"no {split}_* views under {root}")
        with open(split_list[0] / "metadata.json") as f:
            meta = json.load(f)
        self.w, self.h = image_size(config, int(meta.get("w", 800)),
                                    int(meta.get("h", 800)))
        self.img_wh = (self.w, self.h)
        self.near = float(config.get("near_plane", 2.0))
        self.far = float(config.get("far_plane", 6.0))
        self.focal = 0.5 * self.w / math.tan(0.5 * meta["cam_angle_x"])
        self.directions = get_ray_directions(
            self.w, self.h, self.focal, self.focal, self.w // 2, self.h // 2,
            openGL_camera=bool(config.get("openGL_camera", True)))

        has_albedo = bool(config.get("has_albedo", False))
        has_roughness = bool(config.get("has_roughness", False))
        relight_list = list(config.get("relight_list", []) or [])

        c2ws, images, masks, normals = [], [], [], []
        albedos, roughs = [], []
        relight = {l: [] for l in relight_list}
        for item in split_list:
            with open(item / "metadata.json") as f:
                m = json.load(f)
            c2ws.append(np.asarray(
                list(map(float, m["cam_transform_mat"].split(","))),
                np.float32).reshape(4, 4)[:3, :4])
            img = read_image(item / "rgba.png", self.img_wh)
            masks.append(img[..., -1])
            images.append(img[..., :3])

            if has_albedo:
                fmt = config.get("albedo_format", "exr")
                alb = read_exr(str(item / "albedo.exr")) if fmt == "exr" \
                    else read_image(item / f"albedo.{fmt}", self.img_wh)
                albedos.append(alb[..., :3])
            if has_roughness:
                fmt = config.get("roughness_format", "exr")
                rough = read_exr(str(item / "roughness.exr")) \
                    if fmt == "exr" \
                    else read_image(item / f"roughness.{fmt}", self.img_wh)
                if rough.ndim == 2:
                    rough = rough[..., None]
                roughs.append(rough[..., :1])

            normal_img = read_exr(str(item / "normal.exr"))
            normal_bg = np.array([0.0, 0.0, 1.0], np.float32)
            na = normal_img[..., -1:]
            nrm = normal_img[..., :3] * na + normal_bg * (1.0 - na)
            nrm = nrm / np.maximum(
                np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
            normals.append(nrm)

            for light in relight_list:
                relight[light].append(read_image(
                    item / f"rgba_{light}.png", self.img_wh)[..., :3])

        self.all_c2w = np.stack(c2ws)
        self.all_images = np.stack(images)
        self.all_fg_masks = np.stack(masks)
        self.all_normals = np.stack(normals)
        if has_albedo:
            self.all_albedo = np.stack(albedos)
        if has_roughness:
            self.all_roughness = np.stack(roughs)
        self.relight_images = {l: np.stack(v) for l, v in relight.items()}

    def __len__(self):
        return len(self.all_images)


@register("tensoir")
class TensoIRDataModule:
    def __init__(self, config):
        self.config = config

    def split(self, name):
        return TensoIRSplit(self.config, name)

    def train(self):
        return self.split(self.config.get("train_split", "train"))

    def val(self):
        return self.split(self.config.get("val_split", "test"))

    def test(self):
        return self.split(self.config.get("test_split", "test"))
