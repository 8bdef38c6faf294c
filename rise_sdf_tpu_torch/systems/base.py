"""Base system: the train/eval harness (counterpart of
``rise_sdf_tpu/systems/base.py``).

The system owns the model (its parameters), the optimizer and the LR
schedule, and a small ``state`` dict ``{step, occs, occ_binary}``.
Checkpoints use the JAX package's ``k:``-keyed ``.npz`` format
(``bridge.py``) and hold the whole training state: the params, Adam's
moments and count, the schedule's count, the occupancy grid and the
step.  A JAX checkpoint loads whole here and the port's loads whole in
the JAX package's ``load_checkpoint``.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch

from .. import bridge, models
from .optim import make_optimizer
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
        self.optimizer = self.scheduler = None
        self._ckpt_writer = None
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
    def fresh_optimizer(self):
        """A new Adam and LR schedule over the model's parameters."""
        self.optimizer, self.scheduler = make_optimizer(
            self.config["system"], self.model)

    def _state_shapes(self) -> Dict[str, tuple]:
        """Every entry a full checkpoint of this system holds, by JAX
        state path, with its shape."""
        shapes = {bridge.jax_path(n): tuple(p.shape)
                  for n, p in self.model.named_parameters()}
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                path = bridge.jax_path(self._param_names[p])[len("params/"):]
                shapes[bridge.MU + path] = shapes[bridge.NU + path] = \
                    tuple(p.shape)
        cells = (self.model.grid_resolution ** 3,)
        shapes.update({bridge.ADAM_COUNT: (), bridge.SCHEDULE_COUNT: (),
                       "occs": cells, "occ_binary": cells, "step": ()})
        return shapes

    @property
    def _param_names(self):
        return {p: n for n, p in self.model.named_parameters()}

    def save_checkpoint(self, state, path: Optional[str] = None,
                        async_write: bool = False) -> str:
        """Write the whole training state to ``path`` (default
        ``ckpt_dir/step_N.ckpt.npz``) atomically (tmp + rename).  The
        device-to-host copy is synchronous; with ``async_write`` the
        serialization and the write run in one background thread.  At
        most one writer is in flight: a save first joins the previous
        one (``wait_checkpoint_writer``)."""
        path = path or os.path.join(self.ckpt_dir,
                                    f"step_{int(state['step'])}.ckpt.npz")
        if self.optimizer is None:
            self.fresh_optimizer()
        flat = bridge.to_jax_state(self.model, self.optimizer,
                                   self.scheduler)
        flat["occs"] = bridge.host_copy(state["occs"])
        flat["occ_binary"] = bridge.host_copy(state["occ_binary"])
        flat["step"] = np.asarray(int(state["step"]), np.int32)
        self.wait_checkpoint_writer()
        if not async_write:
            return bridge.save_npz(path, flat)
        errors = []

        def write():
            try:
                bridge.save_npz(path, flat)
            except BaseException as e:  # re-raised by the join
                errors.append(e)
                raise

        thread = threading.Thread(target=write, daemon=True)
        self._ckpt_writer = (thread, errors)
        thread.start()
        return path

    def wait_checkpoint_writer(self):
        """Join the asynchronous checkpoint write in flight, if any, and
        raise what it raised."""
        if self._ckpt_writer is None:
            return
        thread, errors = self._ckpt_writer
        thread.join()
        self._ckpt_writer = None
        if errors:
            raise RuntimeError("the background checkpoint write "
                               "failed") from errors[0]

    def _read_checkpoint(self, path: str, keys) -> Dict[str, np.ndarray]:
        """The checkpoint's entries, each of ``keys`` checked: a missing
        one raises ``KeyError`` and a wrong shape ``ValueError``, both
        naming the state path."""
        flat = bridge.load_npz(path)
        shapes = self._state_shapes()
        for key in keys:
            if key not in flat:
                raise KeyError(
                    f"checkpoint {path} has no entry for state path "
                    f"'{key}' — was it saved from a different "
                    "model/optimizer config?")
            if tuple(flat[key].shape) != shapes[key]:
                raise ValueError(
                    f"checkpoint shape mismatch at '{key}': saved "
                    f"{tuple(flat[key].shape)}, state expects "
                    f"{shapes[key]}")
        return flat

    def _load_state(self, flat) -> Dict:
        self.model.load_state_dict(bridge.from_jax_params(flat),
                                   strict=True)
        return {"step": int(flat["step"]),
                "occs": torch.from_numpy(np.array(flat["occs"])).to(
                    self.device),
                "occ_binary": torch.from_numpy(np.array(
                    flat["occ_binary"])).to(self.device)}

    def load_checkpoint(self, path: str) -> Dict:
        """Restore the whole training state: the params, a new optimizer
        holding the saved Adam moments and count (every parameter's
        ``step``), the schedule at the saved count (and the groups' lr
        with it); returns ``{step, occs, occ_binary}``."""
        self.fresh_optimizer()
        flat = self._read_checkpoint(path, self._state_shapes())
        state = self._load_state(flat)
        full = bridge.from_jax_state(flat)
        names = self._param_names
        sd = self.optimizer.state_dict()
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        step = torch.tensor(float(full["count"]), dtype=torch.float32)
        sd["state"] = {i: {"step": step.clone(),
                           "exp_avg": full["exp_avg"][names[p]],
                           "exp_avg_sq": full["exp_avg_sq"][names[p]]}
                       for i, p in enumerate(params)}
        self.optimizer.load_state_dict(sd)
        sched, n = self.scheduler, full["schedule_count"]
        sched.last_epoch = n
        lrs = [base * fn(n) for base, fn in zip(sched.base_lrs,
                                                sched.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs
        return state

    def load_weights_only(self, path: str) -> Dict:
        """Restore the params, the occupancy grid and the step, with a
        fresh optimizer and schedule (``--resume_weights_only``)."""
        self.fresh_optimizer()
        keys = [k for k in self._state_shapes()
                if k.startswith("params/") or k in ("occs", "occ_binary",
                                                    "step")]
        return self._load_state(self._read_checkpoint(path, keys))

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
