"""Colour-space transforms (counterpart of ``rise_sdf_tpu/utils/color.py``)."""

from __future__ import annotations

import torch


def rgb_to_srgb(f: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB transfer curve (no clamp)."""
    return torch.where(
        f <= 0.0031308,
        f * 12.92,
        torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055)
