"""Spawned data-parallel ranks and ``dryrun_multichip`` (counterpart of
``__graft_entry__.dryrun_multichip``).

``spawn(fn, world, backend, args)`` runs ``fn(rank, world, *args)`` in
``world`` new processes joined in one process group (a file rendezvous
in a temporary directory unless ``init_method`` is given); a rank's
error, or a rank that dies, raises in the caller.  The workers are
module-level functions of torch-only modules, so a spawned rank imports
no JAX.

``dryrun_multichip(n, device, backend)`` runs one stage-1 train step of
``tiny_split_config`` (the emitter mips in the loss, the secondary pass,
hybrid finite differences, the curvature probe) over ``n`` ranks and
checks that the loss is finite.  As ``__graft_entry__.dryrun_multichip``
it takes ``table_shards = 2`` when ``n`` is even and at least 4, so
``n = 4`` is data=2 x model=2.  It returns each rank's gradients before
and after the all-reduce and its parameters after the update (a table
shard's rows only), for the caller to hold against the one-process
mean.

    python -m rise_sdf_tpu_torch.parallel.dryrun [--ranks 2]
        [--device cuda|cpu] [--backend nccl|gloo]

(CUDA and NCCL unless asked for the CPU and gloo.)
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from . import sharding


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU, or ``cuda:(rank mod the visible
    GPUs)`` (NCCL takes one GPU per rank; gloo ranks may share one)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, fn, world, backend, init_method, args):
    sharding.initialize_distributed(backend, init_method, rank=rank,
                                    world_size=world, local_rank=rank)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, args=(), init_method=None) -> None:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    process group; returns when every rank has returned."""
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="rise_ranks_")
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, backend, init_method, tuple(args)),
            nprocs=world, join=True, start_method="spawn")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def table_shards_for(n: int) -> int:
    """``__graft_entry__.dryrun_multichip``'s model axis at ``n``
    devices."""
    return 2 if n >= 4 and n % 2 == 0 else 1


def _dryrun_rank(rank, world, device, out_dir):
    from .. import datasets, systems
    from ..presets import tiny_split_config
    from ..systems.neus import _step_seed

    dev = rank_device(device, rank)
    cfg = tiny_split_config()
    cfg["system"]["table_shards"] = table_shards_for(world)
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    system = systems.make(cfg["system"]["name"], cfg, dm,
                          save_dir=os.path.join(out_dir, "save"),
                          device=str(dev))
    state = system.init_state(0)
    # stage 1: the mips in the loss, the secondary pass, the prefilter
    state["step"] = step = system.model.split_sum_kick_in_step
    pre = {}
    for name, p in system.model.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, name=name: pre.__setitem__(name, p.grad.clone()))
    gen = torch.Generator(device=dev)
    mesh = system.mesh
    gen.manual_seed(_step_seed(0, 2 * step, mesh.data_index, mesh.dp))
    data = system.device_data(dm.train())
    rays = system.rank_counts(system.capacity)[0]
    batch = system.sample_batch(gen, data, num_rays=rays)
    aux = system.train_step(state, batch, gen)
    named = dict(system.model.named_parameters())
    res = {"loss": float(aux["loss"]), "mesh": (mesh.dp, mesh.tp),
           "skipped": float(aux["skipped_nonfinite"]),
           "pre": {k: pre.get(k, torch.zeros_like(p)).cpu()
                   for k, p in named.items()},
           "post": {k: p.grad.cpu() for k, p in named.items()},
           "params": {k: p.detach().cpu() for k, p in named.items()}}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def dryrun_multichip(n: int, device: str = "cuda",
                     backend: str = "nccl") -> Dict:
    """One stage-1 step of ``tiny_split_config`` over ``n`` ranks (see
    the module docstring); raises unless the loss is finite and no
    update was skipped.  Returns ``{"loss", "data", "model", "ranks"}``,
    ``ranks`` being each rank's ``pre`` and ``post`` gradients and
    ``params`` by parameter name, on the CPU."""
    out = tempfile.mkdtemp(prefix="rise_dryrun_")
    try:
        spawn(_dryrun_rank, n, backend, args=(device, out))
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"))
                 for r in range(n)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    loss = ranks[0]["loss"]
    if not np.isfinite(loss) or any(r["skipped"] for r in ranks):
        raise RuntimeError(f"dryrun_multichip({n}): loss {loss}, skipped "
                           f"{[r['skipped'] for r in ranks]}")
    dp, tp = ranks[0]["mesh"]
    print(f"dryrun_multichip({n}): ok (data={dp} x model={tp}, {backend} "
          f"on {device}), loss={loss:.4f}", flush=True)
    return {"loss": loss, "data": dp, "model": tp, "ranks": ranks}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="nccl")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device, args.backend)


if __name__ == "__main__":
    main()
