"""Quality metrics (counterpart of ``rise_sdf_tpu/systems/criterions.py``):
PSNR (optionally masked), SSIM and the mean angular error of normal
maps, in plain torch ops on the tensors' device."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred, gt, valid_mask=None):
    """-10 log10(mse); with ``valid_mask`` the mean runs over the masked
    entries (a mask of fewer dimensions covers whole trailing rows)."""
    if valid_mask is None:
        mse = torch.mean((pred - gt) ** 2)
    else:
        diff2 = torch.where(valid_mask, (pred - gt) ** 2, 0.0)
        per = pred.numel() / valid_mask.numel() \
            if valid_mask.dim() < pred.dim() else 1
        mse = diff2.sum() / torch.clamp(valid_mask.sum() * per, min=1)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def binary_cross_entropy(x, y):
    """Mean binary cross-entropy of probabilities ``x`` against ``y``."""
    return -(y * torch.log(x) + (1 - y) * torch.log(1 - x)).mean()


def weighted_mse(pred, gt, weights=None):
    """Squared error, averaged with ``weights`` (broadcast to it) when
    given."""
    return _weighted_mean((pred - gt) ** 2, weights)


def weighted_l1(pred, gt, weights=None):
    """Absolute error, averaged with ``weights`` (broadcast to it) when
    given."""
    return _weighted_mean((pred - gt).abs(), weights)


def _weighted_mean(e, weights):
    if weights is None:
        return e.mean()
    return (e * weights).sum() / torch.clamp(
        torch.broadcast_to(weights, e.shape).sum(), min=1e-8)


def mean_angular_error(pred, gt, mask=None, degrees: bool = False):
    """Mean angle between normal maps [..., 3], over the foreground when
    ``mask`` is given.  The cosine is clamped to [-1 + 1e-7, 1 - 1e-7],
    as the JAX package clamps it (the reference's [1e-8, 1 - 1e-8] caps
    opposite normals at 90 degrees)."""
    dot = torch.sum(pred * gt, -1)
    dot = dot / torch.clamp(torch.linalg.vector_norm(pred, dim=-1)
                            * torch.linalg.vector_norm(gt, dim=-1), min=1e-9)
    err = torch.acos(torch.clamp(dot, -1.0 + 1e-7, 1.0 - 1e-7))
    if degrees:
        err = err * (180.0 / math.pi)
    if mask is not None:
        m = mask.reshape(err.shape)
        return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)
    return err.mean()


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _symmetric_pad(x, pad: int):
    """Pad the last dim by ``pad`` mirrored entries, the edge included
    (numpy's "symmetric")."""
    return torch.cat([x[..., :pad].flip(-1), x, x[..., -pad:].flip(-1)], -1)


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Mean SSIM of two [H, W, C] images: a separable Gaussian window
    over symmetric padding, with jaxNeRF's clamps of the (co)variances
    (float error makes them slightly negative on flat windows)."""
    kern = torch.from_numpy(_gaussian_kernel(filter_size, filter_sigma)).to(
        img0.device, img0.dtype).view(1, 1, -1)
    pad = filter_size // 2

    def conv_last(x):  # [..., N] -> [..., N], valid over the padded rows
        shape = x.shape
        rows = _symmetric_pad(x, pad).reshape(-1, 1, shape[-1] + 2 * pad)
        return F.conv1d(rows, kern).reshape(shape)

    def blur(x):  # [H, W, C]: over H, then over W
        x = x.permute(2, 1, 0)              # [C, W, H]
        x = conv_last(x).transpose(1, 2)    # [C, H, W]
        return conv_last(x).permute(1, 2, 0)

    mu0, mu1 = blur(img0), blur(img1)
    sigma00 = torch.clamp(blur(img0 ** 2) - mu0 ** 2, min=0.0)
    sigma11 = torch.clamp(blur(img1 ** 2) - mu1 ** 2, min=0.0)
    sigma01 = blur(img0 * img1) - mu0 * mu1
    sigma01 = torch.sign(sigma01) * torch.minimum(
        torch.sqrt(sigma00 * sigma11), torch.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu0 * mu1 + c1) * (2 * sigma01 + c2)
    denom = (mu0 ** 2 + mu1 ** 2 + c1) * (sigma00 + sigma11 + c2)
    return torch.mean(numer / denom)
