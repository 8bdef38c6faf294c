"""LPIPS perceptual metric (VGG16 backbone) in torch (counterpart of
``rise_sdf_tpu/systems/lpips.py``).

The metric is on only when a weights file is present: the path in
``RISE_SDF_LPIPS_WEIGHTS``, else ``load/lpips/vgg16_lpips.npz``, as
``scripts/convert_lpips_weights.py`` writes it (``conv{i}_w`` in HWIO
layout ``[3, 3, cin, cout]``, ``conv{i}_b``, ``lin{k}`` flat ``[C]``).
``lpips()`` returns ``None`` without one, and the test protocol then
leaves its ``*_lpips`` keys out.  ``available()`` prints one note when
the file is missing; ``reset_cache()`` checks for it again.

The network, as JAX computes it: inputs ``x * 2 - 1``, shifted and
scaled; 13 3x3 convs (SAME padding, ReLU) in the VGG16 blocks (64, 2)
(128, 2) (256, 3) (512, 3) (512, 3) with a 2x2 max-pool between blocks;
each block's features normalised per pixel (norm floored at 1e-10); the
squared difference weighted by ``lin{k}``, averaged over the pixels and
summed over the blocks.  It runs in float32 with ``F.conv2d`` (the conv
weights transposed to OIHW once, per device), TF32 off: cuDNN's default
TF32 would put the card about 1e-3 away from the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_WEIGHTS_PATH = os.environ.get("RISE_SDF_LPIPS_WEIGHTS",
                               "load/lpips/vgg16_lpips.npz")
_CACHE = {"weights": None, "checked": False, "warned": False, "device": {}}

# VGG16 feature config: (out_channels, n_convs) per block
_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _load_weights():
    if _CACHE["checked"]:
        return _CACHE["weights"]
    _CACHE["checked"] = True
    path = os.environ.get("RISE_SDF_LPIPS_WEIGHTS", _WEIGHTS_PATH)
    if os.path.exists(path):
        _CACHE["weights"] = dict(np.load(path))
    return _CACHE["weights"]


def available() -> bool:
    ok = _load_weights() is not None
    if not ok and not _CACHE["warned"]:
        _CACHE["warned"] = True
        print("NOTE: LPIPS disabled — no VGG16 weights at "
              f"'{_WEIGHTS_PATH}' (set RISE_SDF_LPIPS_WEIGHTS to enable); "
              "PSNR/SSIM are still reported", flush=True)
    return ok


def reset_cache():
    """Re-check the weights file (tests / late weight drops)."""
    _CACHE.update({"weights": None, "checked": False, "warned": False,
                   "device": {}})


def _device_weights(w, device: torch.device):
    """The weights on ``device``: conv weights as OIHW, the input
    shift and scale as [1, 3, 1, 1]."""
    key = str(device)
    if key not in _CACHE["device"]:
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
                device)

        n_convs = sum(n for _, n in _BLOCKS)
        _CACHE["device"][key] = {
            "convs": [(t(np.transpose(w[f"conv{i}_w"], (3, 2, 0, 1))),
                       t(w[f"conv{i}_b"])) for i in range(n_convs)],
            "lins": [t(w[f"lin{k}"]).reshape(1, -1, 1, 1)
                     for k in range(len(_BLOCKS))],
            "shift": t(_SHIFT).reshape(1, 3, 1, 1),
            "scale": t(_SCALE).reshape(1, 3, 1, 1)}
    return _CACHE["device"][key]


def _features(x, dw):
    """[1, 3, H, W] in [0, 1] -> the five blocks' features."""
    h = (x * 2.0 - 1.0 - dw["shift"]) / dw["scale"]
    feats, ci = [], 0
    for bi, (_, n) in enumerate(_BLOCKS):
        for _ in range(n):
            wt, b = dw["convs"][ci]
            h = F.relu(F.conv2d(h, wt, b, padding=1))
            ci += 1
        feats.append(h)
        if bi < len(_BLOCKS) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


@torch.no_grad()
def lpips(img0: np.ndarray, img1: np.ndarray,
          device="cuda") -> Optional[float]:
    """img0/img1: [H, W, 3] in [0, 1] -> LPIPS on ``device``, or None
    when there are no weights."""
    w = _load_weights()
    if w is None:
        return None
    device = torch.device(device)
    dw = _device_weights(w, device)

    def image(a):
        a = torch.as_tensor(np.asarray(a, np.float32), device=device)
        return a.permute(2, 0, 1)[None]

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        f0 = _features(image(img0), dw)
        f1 = _features(image(img1), dw)
    total = torch.zeros((), device=device)
    for a, b, lin in zip(f0, f1, dw["lins"]):
        a = a / torch.clamp_min(torch.linalg.vector_norm(
            a, dim=1, keepdim=True), 1e-10)
        b = b / torch.clamp_min(torch.linalg.vector_norm(
            b, dim=1, keepdim=True), 1e-10)
        total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1))
    return float(total)
