"""Data-parallel training and eval over ``torch.distributed`` ranks,
with hash-table row sharding (counterpart of
``rise_sdf_tpu/parallel/sharding.py``'s ``data`` and ``model`` axes).

One process per rank: NCCL between GPUs (one GPU per process), gloo on
the CPU or for ranks that share one card.  The ``world = dp * tp``
ranks form a (data, model) grid (``Mesh``): rank ``r`` has data index
``r // tp`` and model index ``r % tp``, the order of JAX's
``devices.reshape(-1, tp)``.  ``tp`` is ``system.table_shards``
(``table_shard_count``; 1, the default, is pure data parallel).  The
semantics are the JAX package's ``shard_map`` over that mesh:

* each data index draws ``train_num_rays // dp`` rays (at least 1) and
  marches them into its own buffer of ``capacity // dp`` slots (at
  least 16) (``per_rank_counts``), and takes its own mean loss; the
  ``tp`` ranks of one data index (its *model group*) draw the same
  rays;
* with ``tp > 1`` each rank holds rows ``[m T / tp, (m + 1) T / tp)``
  of every hash table (and their Adam moments): an encode gathers the
  rows its shard owns and one all-reduce over the model group
  reassembles the features (``ops/hashgrid.py``);
* the gradients are averaged after the backward (``all_reduce_mean_``,
  JAX's ``pmean``): a table shard's over its *data group* (the ``dp``
  ranks of one model index), every other gradient over the world,
  which is the same mean since the model group's copies are equal and
  keeps the replicated parameters bit-equal on every rank; then the aux
  scalars, the loss and the finite-grads flag over the world, so every
  rank skips together; the optimizer update runs on every rank;
* an eval chunk's rays are split over the data group (``shard_rays``)
  and the per-ray outputs gathered back in rank order (``gather_rays``);
  the model group renders the same rays.

Without a process group every function here is the one-process case:
one shard, no collective.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

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


def world_size() -> int:
    """The ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def data_shard_count() -> int:
    """The world size; 1 without a process group.  A system's data
    shards are its ``mesh.dp``."""
    return world_size()


def table_shard_count(table_shards: int = 1,
                      world: Optional[int] = None,
                      table_size: Optional[int] = None) -> int:
    """The model-axis size for ``system.table_shards`` at ``world`` ranks
    (the process group's size by default).  One rank is one shard, as
    the JAX launcher builds no mesh on one device; over ranks
    ``table_shards`` must divide the world, and the hash tables'
    ``table_size`` rows (when given) must split evenly over it."""
    tp = int(table_shards)
    world = world_size() if world is None else int(world)
    if tp < 1:
        raise ValueError(f"table_shards is at least 1, not {tp}")
    if world == 1:
        return 1
    if world % tp:
        raise ValueError(f"table_shards={tp} does not divide the "
                         f"{world} ranks")
    if table_size is not None and table_size % tp:
        raise ValueError(f"a hash table of {table_size} rows does not "
                         f"split into {tp} shards")
    return tp


class Mesh(NamedTuple):
    """This rank's place on the (data, model) grid and its groups: the
    ``data_group`` holds the ``dp`` ranks of its model index, the
    ``model_group`` the ``tp`` ranks of its data index.  A group is
    None where it is the world (``tp == 1``: the data group) or where
    the rank is alone in it (``tp == 1``: the model group)."""
    dp: int
    tp: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object


_GROUPS: Dict[int, tuple] = {}


def make_mesh(table_shards: int = 1,
              table_size: Optional[int] = None) -> Mesh:
    """This rank's ``Mesh`` at ``table_shards`` (``table_shard_count``).
    With ``tp > 1`` it makes the process groups of every data and every
    model index the first time (every rank must call it, in the same
    order) and keeps them for the process group's life."""
    world = world_size()
    tp = table_shard_count(table_shards, world, table_size)
    r = rank()
    if tp == 1:
        return Mesh(world, 1, r, 0, None, None)
    made = _GROUPS.get(tp)
    if made is None or made[0] is not dist.group.WORLD:
        dp = world // tp
        model = [dist.new_group([d * tp + m for m in range(tp)])
                 for d in range(dp)]
        data = [dist.new_group([d * tp + m for d in range(dp)])
                for m in range(tp)]
        made = _GROUPS[tp] = (dist.group.WORLD, model, data)
    _, model, data = made
    d, m = divmod(r, tp)
    return Mesh(world // tp, tp, d, m, data[m], model[d])


def group_size(group) -> int:
    """Ranks of ``group`` (None: the world)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_gather_shards(shard: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``shard`` of ``group``, in rank order."""
    parts = [torch.empty_like(shard) for _ in range(group_size(group))]
    dist.all_gather(parts, shard.contiguous(), group=group)
    return parts


def all_gather_rows(shard: torch.Tensor, group, dim: int = 1
                    ) -> torch.Tensor:
    """The shards of ``group``'s ranks joined along ``dim`` in rank
    order: a table of shape ``[L, T / tp, F]`` gathered to ``[L, T,
    F]`` over a model group."""
    return torch.cat(all_gather_shards(shard, group), dim)


def per_rank_counts(num_rays: int, capacity: int,
                    dp: int) -> Tuple[int, int]:
    """Each rank's rays and sample buffer at ``dp`` data shards, as the
    JAX train step splits them: ``max(num_rays // dp, 1)`` and
    ``max(capacity // dp, 16)``."""
    return max(num_rays // dp, 1), per_rank_buffer(capacity, dp)


def per_rank_buffer(capacity: int, dp: int) -> int:
    """Each rank's share of a sample buffer, at least 16 slots (the JAX
    train step's and eval chunk's rule)."""
    return max(capacity // dp, 16)


def barrier():
    if dist.is_initialized():
        dist.barrier()


def all_reduce_mean_(tensors: List[torch.Tensor], group=None) -> None:
    """Replace each tensor with its mean over the ranks of ``group`` (the
    world by default): the tensors go into one flat bucket, one
    all-reduce sums it, and a divide by the group's size makes the mean
    (a sum of two ranks is the same in either order, so two ranks see
    the one-process mean bit for bit).  The tensors share one dtype and
    device.  No-op without a process group or on a group of one."""
    if not dist.is_initialized() or not tensors or group_size(group) == 1:
        return
    bucket = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(bucket, group=group)
    bucket /= group_size(group)
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


def gather_rays(outs: Dict[str, torch.Tensor],
                group=None) -> Dict[str, torch.Tensor]:
    """The per-ray outputs (each ``[n_local, ...]``) of every rank of
    ``group`` (the world by default), joined in rank order: one
    all-gather of a bucket ``[n_local, C]`` in float32 (float64 when an
    output is), through which floating and boolean outputs pass
    exactly; without a process group, or on a group of one, the outputs
    come back as they are."""
    if not dist.is_initialized() or group_size(group) == 1:
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
    parts = [torch.empty_like(bucket) for _ in range(group_size(group))]
    dist.all_gather(parts, bucket, group=group)
    full = torch.cat(parts)
    res, offset = {}, 0
    for k, c in zip(keys, cols):
        v = outs[k]
        col = full[:, offset:offset + c.shape[1]]
        offset += c.shape[1]
        col = col > 0.5 if v.dtype == torch.bool else col.to(v.dtype)
        res[k] = col.reshape(-1, *v.shape[1:])
    return res
