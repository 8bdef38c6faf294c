"""Camera ray helpers (counterpart of ``rise_sdf_tpu/utils/rays.py``)."""

from __future__ import annotations

import numpy as np
import torch


def get_ray_directions(w, h, fx, fy, cx, cy, use_pixel_centers=True,
                       openGL_camera=True) -> np.ndarray:
    """[H, W, 3] camera-space directions (numpy, as the JAX helper)."""
    pc = 0.5 if use_pixel_centers else 0.0
    i, j = np.meshgrid(
        np.arange(w, dtype=np.float32) + pc,
        np.arange(h, dtype=np.float32) + pc,
        indexing="xy",
    )
    z = -np.ones_like(i) if openGL_camera else np.ones_like(i)
    return np.stack([(i - cx) / fx, -(j - cy) / fy, z], -1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Rotate/translate camera rays to world.

    directions: [N,3] with c2w [N,3,4], or [H,W,3] with c2w [3,4].
    Returns flattened (rays_o, rays_d) [M,3].
    """
    if directions.dim() == 2:
        rays_d = (directions[:, None, :] * c2w[:, :3, :3]).sum(-1)
        rays_o = c2w[:, :, 3].expand_as(rays_d)
    else:
        rays_d = (directions[:, :, None, :] * c2w[None, None, :3, :3]).sum(-1)
        rays_o = c2w[None, None, :, 3].expand_as(rays_d)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
