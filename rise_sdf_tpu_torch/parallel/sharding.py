"""Data-parallel training and eval over ``torch.distributed`` ranks
(counterpart of ``rise_sdf_tpu/parallel/sharding.py``'s ``data`` axis).

One process per rank: NCCL between GPUs (one GPU per process), gloo on
the CPU or for ranks that share one card.  The semantics are the JAX
package's ``shard_map`` over a 1-D ``data`` mesh:

* each rank draws ``train_num_rays // dp`` rays (at least 1) and marches
  them into its own buffer of ``capacity // dp`` slots (at least 16)
  (``per_rank_counts``), and takes its own mean loss;
* the gradients are averaged over the ranks after the backward
  (``all_reduce_mean_``, JAX's ``pmean``), then the aux scalars and the
  loss in a second collective; the finite-grads guard sees the averaged
  gradients, so every rank skips together; the optimizer update runs on
  every rank (replicated);
* an eval chunk's rays are split over the ranks (``shard_rays``) and
  the per-ray outputs gathered back in rank order (``gather_rays``).

Without a process group every function here is the one-process case:
one shard, no collective.  The ``model`` mesh axis (hash-table row
sharding) is not ported: ``table_shard_count`` raises for it.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# a rank that misses a collective fails the run after this long instead
# of hanging every rank
TIMEOUT = datetime.timedelta(minutes=5)


def initialize_distributed(backend: str, init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           local_rank: Optional[int] = None
                           ) -> Tuple[int, int, int]:
    """Join the process group; returns ``(rank, world_size,
    local_rank)``.  ``rank``, ``world_size`` and ``local_rank`` default
    to torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, and
    ``init_method`` to ``env://`` (torchrun's ``MASTER_ADDR`` and
    ``MASTER_PORT``).  ``backend`` is ``"nccl"`` (one GPU per process:
    the process's device becomes ``cuda:local_rank`` before the group
    forms) or ``"gloo"`` (CPU tensors, or CUDA tensors of ranks that
    share a card); it is used as given."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend is 'nccl' or 'gloo', not {backend!r}")
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None \
        else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None \
        else local_rank
    device = None
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT, device_id=device)
    return rank, world_size, local_rank


def is_main_process() -> bool:
    """Rank 0, or no process group: the process that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def data_shard_count() -> int:
    """The world size; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def table_shard_count(table_shards: int = 1) -> int:
    """Hash-table row sharding (JAX's ``model`` mesh axis) is not
    ported; 1 is the only count."""
    if table_shards > 1:
        raise NotImplementedError(
            "table_shards > 1 (hash-table row sharding over a 'model' "
            "axis) is not ported; see ROADMAP.md, Queue 1")
    return 1


def per_rank_counts(num_rays: int, capacity: int,
                    dp: int) -> Tuple[int, int]:
    """Each rank's rays and sample buffer at ``dp`` ranks, as the JAX
    train step splits them: ``max(num_rays // dp, 1)`` and
    ``max(capacity // dp, 16)``."""
    return max(num_rays // dp, 1), per_rank_buffer(capacity, dp)


def per_rank_buffer(capacity: int, dp: int) -> int:
    """Each rank's share of a sample buffer, at least 16 slots (the JAX
    train step's and eval chunk's rule)."""
    return max(capacity // dp, 16)


def barrier():
    if dist.is_initialized():
        dist.barrier()


def all_reduce_mean_(tensors: List[torch.Tensor]) -> None:
    """Replace each tensor with its mean over the ranks: the tensors go
    into one flat bucket, one all-reduce sums it, and a divide by the
    world size makes the mean (a sum of two ranks is the same in either
    order, so two ranks see the one-process mean bit for bit).  The
    tensors share one dtype and device.  No-op without a process
    group."""
    if not dist.is_initialized() or not tensors:
        return
    bucket = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(bucket)
    bucket /= dist.get_world_size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(bucket[offset:offset + n].view_as(t))
        offset += n


def all_reduce_mean_scalars(scalars: Dict[str, object],
                            device) -> Dict[str, object]:
    """Each scalar's mean over the ranks, as a float32 0-dim tensor on
    ``device``, in one collective (JAX ``pmean``s the aux and the loss
    in float32).  Without a process group the scalars come back as they
    are."""
    if not dist.is_initialized():
        return scalars
    keys = list(scalars)
    vals = torch.stack([torch.as_tensor(scalars[k], dtype=torch.float32,
                                        device=device).detach().reshape(())
                        for k in keys])
    all_reduce_mean_([vals])
    return dict(zip(keys, vals.unbind()))


def shard_rays(rays: torch.Tensor, dp: int, index: int) -> torch.Tensor:
    """Shard ``index`` of ``dp`` equal shards of a chunk's rays (JAX's
    ``P("data")`` split of an eval chunk)."""
    n = rays.shape[0]
    if n % dp:
        raise ValueError(f"an eval chunk of {n} rays does not split over "
                         f"{dp} ranks")
    return rays[index * (n // dp):(index + 1) * (n // dp)]


def gather_rays(outs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every rank's per-ray outputs (each ``[n_local, ...]``), joined in
    rank order: one all-gather of a bucket ``[n_local, C]`` in float32
    (float64 when an output is), through which floating and boolean
    outputs pass exactly; without a process group the outputs come back
    as they are."""
    if not dist.is_initialized():
        return outs
    keys = sorted(outs)
    n = outs[keys[0]].shape[0]
    for k in keys:
        v = outs[k]
        if v.shape[0] != n or not (v.dtype == torch.bool
                                   or v.dtype.is_floating_point):
            raise ValueError(f"gather_rays takes per-ray float or bool "
                             f"outputs; '{k}' is {v.dtype} "
                             f"{tuple(v.shape)}")
    dtype = torch.float64 if any(outs[k].dtype == torch.float64
                                 for k in keys) else torch.float32
    cols = [outs[k].reshape(n, -1).to(dtype) for k in keys]
    bucket = torch.cat(cols, 1).contiguous()
    parts = [torch.empty_like(bucket) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, bucket)
    full = torch.cat(parts)
    res, offset = {}, 0
    for k, c in zip(keys, cols):
        v = outs[k]
        col = full[:, offset:offset + c.shape[1]]
        offset += c.shape[1]
        col = col > 0.5 if v.dtype == torch.bool else col.to(v.dtype)
        res[k] = col.reshape(-1, *v.shape[1:])
    return res
