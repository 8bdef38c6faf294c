"""Colour-space transforms (counterpart of ``rise_sdf_tpu/utils/color.py``)."""

from __future__ import annotations

import numpy as np
import torch


def rgb_to_srgb(f: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB transfer curve (no clamp)."""
    return torch.where(
        f <= 0.0031308,
        f * 12.92,
        torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055)


def srgb_to_rgb(f: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear transfer curve (the inverse of ``rgb_to_srgb``)."""
    return torch.where(
        f <= 0.04045,
        f / 12.92,
        torch.pow((torch.clamp(f, min=0.04045) + 0.055) / 1.055, 2.4))


def linear_to_srgb_np(linear: np.ndarray) -> np.ndarray:
    """Linear -> sRGB on the host (the test protocol's white background
    and the exported material maps)."""
    eps = np.finfo(np.float32).eps
    srgb0 = 323 / 25 * linear
    srgb1 = (211 * np.maximum(eps, linear) ** (5 / 12) - 11) / 200
    return np.where(linear <= 0.0031308, srgb0, srgb1)
