"""Parameter bridge between the JAX package's checkpoints and the port.

JAX checkpoints (``rise_sdf_tpu/systems/base.py:save_checkpoint``) are
``.npz`` files keyed ``"k:" + path``, where a path joins the pytree keys
with ``/`` (``params/geometry/mlp/layers/0/v``).  The port's module
names follow those pytrees, with one difference: the hash grid sits
inside a ``CompositeEncoding`` module, so JAX's
``geometry/encoding/table`` is the port's ``geometry.encoding.encoding.table``.

``to_jax_params`` / ``from_jax_params`` carry the ``params/*`` entries
alone.  ``to_jax_state`` / ``from_jax_state`` carry the whole training
state beside them, in the keys of the JAX package's optax chain
(``scale_by_adam``, a stateless per-group scale, ``scale_by_schedule``,
``scale``): ``opt_state/0/count`` (Adam's update count, one scalar: the
``step`` of every torch parameter), ``opt_state/0/mu/<param>`` and
``opt_state/0/nu/<param>`` (torch's ``exp_avg`` and ``exp_avg_sq``),
``opt_state/2/count`` (the schedule's count: ``LambdaLR.last_epoch``).
The system adds ``occs``, ``occ_binary`` and ``step``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

_PREFIX = "params/"


def torch_key(path: str) -> str:
    """``params/geometry/encoding/table`` -> ``geometry.encoding.encoding.table``."""
    if not path.startswith(_PREFIX):
        raise KeyError(f"not a params path: {path}")
    return path[len(_PREFIX):].replace(
        "encoding/table", "encoding/encoding/table").replace("/", ".")


def jax_path(key: str) -> str:
    """Inverse of :func:`torch_key`."""
    return _PREFIX + key.replace(".", "/").replace(
        "encoding/encoding/table", "encoding/table")


def flatten_params(tree, prefix: str = "params") -> Dict[str, np.ndarray]:
    """An in-memory params pytree (nested dicts and lists of arrays, as
    the JAX package's ``init`` returns) -> flat path-keyed arrays."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_params(v, f"{prefix}/{k}"))
    return out


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``params/*`` entries of a flat JAX checkpoint -> a state_dict."""
    return {torch_key(k): torch.from_numpy(np.array(v))
            for k, v in flat.items() if k.startswith(_PREFIX)}


def to_jax_params(state_dict) -> Dict[str, np.ndarray]:
    """A state_dict -> flat ``params/*`` arrays in the JAX key format."""
    return {jax_path(k): v.detach().cpu().numpy()
            for k, v in state_dict.items()}


MU, NU = "opt_state/0/mu/", "opt_state/0/nu/"
ADAM_COUNT, SCHEDULE_COUNT = "opt_state/0/count", "opt_state/2/count"


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a live tensor: an asynchronous
    writer may still read it while training goes on)."""
    return t.detach().to("cpu", copy=True).numpy()


def to_jax_state(model, optimizer, scheduler) -> Dict[str, np.ndarray]:
    """The model's params, Adam's moments and count and the schedule's
    count as flat JAX-keyed host arrays.  A parameter without Adam state
    yet (no update taken) writes zero moments, as optax's init does.
    Raises ``ValueError`` when the parameters' step counts differ: the
    JAX state has one count for all."""
    flat = {jax_path(k): host_copy(v) for k, v in model.state_dict().items()}
    names = {p: n for n, p in model.named_parameters()}
    counts = set()
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            path = jax_path(names[p])[len(_PREFIX):]
            for prefix, k in ((MU, "exp_avg"), (NU, "exp_avg_sq")):
                flat[prefix + path] = host_copy(st[k]) if k in st else \
                    torch.zeros_like(p, device="cpu").numpy()
            counts.add(int(st["step"]) if "step" in st else 0)
    if len(counts) > 1:
        raise ValueError(f"Adam's step counts differ across parameters: "
                         f"{sorted(counts)}")
    flat[ADAM_COUNT] = np.asarray(counts.pop() if counts else 0, np.int32)
    flat[SCHEDULE_COUNT] = np.asarray(scheduler.last_epoch, np.int32)
    return flat


def from_jax_state(flat: Dict[str, np.ndarray]) -> Dict:
    """A flat JAX state -> ``{"params": state_dict, "exp_avg": {key:
    tensor}, "exp_avg_sq": {key: tensor}, "count": int,
    "schedule_count": int}``, keyed by torch parameter name.  Entries
    are taken as they are: the system checks the keys and shapes it
    needs (``BaseSystem.load_checkpoint``)."""
    def moments(prefix):
        return {torch_key(_PREFIX + k[len(prefix):]):
                torch.from_numpy(np.array(v))
                for k, v in flat.items() if k.startswith(prefix)}

    return {"params": from_jax_params(flat), "exp_avg": moments(MU),
            "exp_avg_sq": moments(NU),
            "count": int(flat.get(ADAM_COUNT, 0)),
            "schedule_count": int(flat.get(SCHEDULE_COUNT, 0))}


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint's entries with the ``k:`` prefix stripped."""
    with np.load(path) as data:
        return {k[2:] if k.startswith("k:") else k: data[k]
                for k in data.files}


def save_npz(path: str, flat: Dict[str, np.ndarray]) -> str:
    """Write ``flat`` as ``k:``-keyed npz, atomically (tmp + rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{"k:" + k: v for k, v in flat.items()})
    os.replace(tmp, path)
    return path
