"""NeRF-synthetic (Blender) scene loader (counterpart of
``rise_sdf_tpu/datasets/blender.py``).

Reads ``transforms_{split}.json`` (``camera_angle_x``, optional ``w`` and
``h``, and per frame ``transform_matrix`` and ``file_path``) and each
frame's ``{file_path}.png`` through ``utils/png.py`` and PIL's bicubic
resize (``utils/image.py``).  A grey image is stacked to RGB with alpha
1 and an RGB one gets alpha 1; the alpha channel is the mask.  The
arrays stay on the host.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from . import register
from .tensoir import image_size
from ..utils.image import read_image
from ..utils.rays import get_ray_directions


class BlenderSplit:
    def __init__(self, config, split):
        self.config = config
        self.split = split
        self.has_mask = True
        self.apply_mask = True

        with open(os.path.join(config["root_dir"],
                               f"transforms_{split}.json")) as f:
            meta = json.load(f)
        if "w" in meta and "h" in meta:
            w_file, h_file = int(meta["w"]), int(meta["h"])
        else:
            w_file, h_file = 800, 800
        self.w, self.h = image_size(config, w_file, h_file)
        self.img_wh = (self.w, self.h)
        self.near = float(config.get("near_plane", 2.0))
        self.far = float(config.get("far_plane", 6.0))
        self.focal = 0.5 * self.w / math.tan(0.5 * meta["camera_angle_x"])
        self.directions = get_ray_directions(
            self.w, self.h, self.focal, self.focal, self.w // 2, self.h // 2,
            openGL_camera=bool(config.get("openGL_camera", True)))

        c2ws, images, masks = [], [], []
        for frame in meta["frames"]:
            c2ws.append(np.asarray(frame["transform_matrix"],
                                   np.float32)[:3, :4])
            img = read_image(os.path.join(config["root_dir"],
                                          f"{frame['file_path']}.png"),
                             self.img_wh)
            if img.ndim == 2:
                img = np.stack([img] * 3 + [np.ones_like(img)], -1)
            if img.shape[-1] == 3:
                img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
            masks.append(img[..., -1])
            images.append(img[..., :3])
        self.all_c2w = np.stack(c2ws)
        self.all_images = np.stack(images)
        self.all_fg_masks = np.stack(masks)

    def __len__(self):
        return len(self.all_images)


@register("blender")
class BlenderDataModule:
    def __init__(self, config):
        self.config = config

    def split(self, name):
        return BlenderSplit(self.config, name)

    def train(self):
        return self.split(self.config.get("train_split", "train"))

    def val(self):
        return self.split(self.config.get("val_split", "val"))

    def test(self):
        return self.split(self.config.get("test_split", "test"))
