"""Base system: the train/eval harness (counterpart of
``rise_sdf_tpu/systems/base.py``).

The system owns the model (its parameters), the optimizer and a small
``state`` dict ``{step, occs, occ_binary}``.  Checkpoints use the JAX
package's ``k:``-keyed ``.npz`` format (``bridge.py``), so a JAX
checkpoint's weights load here and the port's load there.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

import torch

from .. import bridge, models
from ..utils.saving import Saver


class BaseSystem:
    def __init__(self, config, datamodule, save_dir: str = "exp_out",
                 ckpt_dir: Optional[str] = None, device="cuda"):
        self.config = config
        self.datamodule = datamodule
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available; pass device='cpu' to run on "
                    "the CPU")
            # float32 means float32: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = models.make(config["model"]["name"],
                                 config["model"]).to(self.device)
        self.save_dir = save_dir
        self.saver = Saver(save_dir)
        self.ckpt_dir = ckpt_dir or os.path.join(save_dir, "ckpt")
        self.prepare()

    def prepare(self):
        pass

    # ------------------------------------------------------------------ #
    @staticmethod
    def C(value, step):
        """Scalar schedule: a number or ``[start_step, start, end,
        end_step]`` (3-element lists get start_step=0)."""
        if isinstance(value, (int, float)):
            return value
        value = list(value)
        if len(value) == 3:
            value = [0] + value
        start_step, start_value, end_value, end_step = value
        assert isinstance(end_step, int), "epoch-based schedules unsupported"
        t = min(max((step - start_step) / max(end_step - start_step, 1),
                    0.0), 1.0)
        return start_value + (end_value - start_value) * t

    @staticmethod
    def masked_mean(x, mask):
        """Mean over masked entries; broadcast mask over trailing dims."""
        while mask.dim() < x.dim():
            mask = mask[..., None]
        num = torch.sum(torch.where(mask, x, 0.0))
        den = torch.clamp(mask.expand_as(x).sum(), min=1.0)
        return num / den

    @contextmanager
    def frozen_params(self):
        """Parameters stop requiring grad inside (eval renders still need
        autograd for the SDF gradient, but only with respect to x)."""
        flags = [(p, p.requires_grad) for p in self.model.parameters()]
        for p, _ in flags:
            p.requires_grad_(False)
        try:
            yield
        finally:
            for p, f in flags:
                p.requires_grad_(f)

    # ------------------------------------------------------------------ #
    def save_checkpoint(self, state, path: Optional[str] = None) -> str:
        """params (JAX key format) + occupancy grid + step."""
        path = path or os.path.join(self.ckpt_dir,
                                    f"step_{int(state['step'])}.ckpt.npz")
        flat = bridge.to_jax_params(self.model.state_dict())
        flat["occs"] = state["occs"].cpu().numpy()
        flat["occ_binary"] = state["occ_binary"].cpu().numpy()
        flat["step"] = torch.tensor(int(state["step"]),
                                    dtype=torch.int32).numpy()
        return bridge.save_npz(path, flat)

    def load_checkpoint(self, path: str):
        """Load params into the model (every parameter must be present at
        its shape) and return the saved state.  The optimizer state is not
        in the file: the optimizer starts fresh (JAX ``load_weights_only``)."""
        flat = bridge.load_npz(path)
        self.model.load_state_dict(bridge.from_jax_params(flat), strict=True)
        return {"step": int(flat["step"]),
                "occs": torch.from_numpy(flat["occs"]).to(self.device),
                "occ_binary": torch.from_numpy(
                    flat["occ_binary"]).to(self.device)}

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def update_occupancy(self, state, generator, subset_fraction: int = 4):
        """Occupancy-grid EMA sweep over a rotating 1/``subset_fraction``
        of the cells (all cells refresh within 4 updates = 64 steps)."""
        model = self.model
        res = model.grid_resolution
        thre = float(self.config["model"].get("grid_prune_occ_thre", 0.01))
        k = max(subset_fraction, 1)
        n = res ** 3 // k
        phase = (int(state["step"]) // 16) % k
        idx = torch.arange(n, device=self.device) * k + phase
        ijk = torch.stack([idx // (res * res), (idx // res) % res, idx % res],
                          -1).float()
        u = torch.rand((n, 3), generator=generator, device=self.device)
        pos = model.aabb_min + (ijk + u) / res * (model.aabb_max
                                                  - model.aabb_min)
        occ = model.occ_eval(pos, int(state["step"]))
        occs = state["occs"]  # updated in place
        occs[idx] = torch.maximum(occs[idx] * 0.95, occ.reshape(-1))
        state["occ_binary"] = occs > torch.clamp(occs.mean(), max=thre)
