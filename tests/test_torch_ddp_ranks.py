"""Rank workers of the data-parallel tests (``tests/test_torch_ddp*.py``)
and the tests of ``parallel/sharding.py`` that need no process group
and no JAX.

The workers run in processes spawned by ``rise_sdf_tpu_torch.parallel.
dryrun.spawn``, which import this module by name: it imports torch and
the port only, so a spawned rank imports no JAX.  Each worker writes
its rank's results to ``out_dir/rank{r}.pt`` for the test to read.
"""

import os

import numpy as np
import pytest
import torch

from rise_sdf_tpu_torch import bridge, datasets, presets, systems
from rise_sdf_tpu_torch.parallel import sharding
from rise_sdf_tpu_torch.utils import saving


def _system(cfg, save_dir):
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    return systems.make(cfg["system"]["name"], cfg, dm, save_dir=save_dir,
                        device="cpu")


def _save(out_dir, rank, res):
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def whole_state(system, state):
    """Every tensor of the training state, by JAX path."""
    flat = bridge.to_jax_state(system.model, system.optimizer,
                               system.scheduler)
    flat["occs"] = state["occs"].numpy().copy()
    flat["occ_binary"] = state["occ_binary"].numpy().copy()
    flat["step"] = np.asarray(state["step"])
    return flat


def _double(batch):
    return {k: torch.from_numpy(v).double() for k, v in batch.items()}


def _grads(system):
    return {k: p.grad.clone() for k, p in system.model.named_parameters()}


# --------------------------------------------------------------------- #
def neus_steps_rank(rank, world, ckpt, batches, grid, out_dir):
    """The tiny NeuS system from the JAX checkpoint ``ckpt``, in float64
    with a fresh Adam, takes one ``train_step`` per entry of ``batches``
    (each a list of the ranks' numpy batches) with ``generator=None``,
    on the occupancy ``grid``; then a step whose batch is poisoned (NaN
    colours) on rank 1 alone.  Records the loss and skip flag of every
    step, the first step's gradients before (``pre``) and after
    (``post``) the all-reduce, and the params after the clean steps and
    after the poisoned one."""
    system = _system(presets.tiny_neus_config(), os.path.join(out_dir, "s"))
    state = system.load_checkpoint(ckpt)
    system.model.double()
    system.fresh_optimizer()
    state["occ_binary"] = torch.from_numpy(grid)
    pre = {}

    def first_grad(p, name):  # this rank's own, before the all-reduce
        if name not in pre:
            pre[name] = p.grad.clone()

    for name, p in system.model.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, name=name: first_grad(p, name))
    res = {"loss": [], "skipped": []}
    for i, step_batches in enumerate(batches):
        aux = system.train_step(state, _double(step_batches[rank]),
                                generator=None)
        res["loss"].append(float(aux["loss"]))
        res["skipped"].append(float(aux["skipped_nonfinite"]))
        if i == 0:
            res["pre"], res["post"] = dict(pre), _grads(system)
    res["params"] = bridge.to_jax_params(system.model.state_dict())
    batch = _double(batches[0][rank])
    if rank == 1:
        batch["rgb"] = torch.full_like(batch["rgb"], float("nan"))
    aux = system.train_step(state, batch, generator=None)
    res["poisoned_skipped"] = float(aux["skipped_nonfinite"])
    res["skipped_updates"] = system.skipped_updates
    res["params_after_poison"] = bridge.to_jax_params(
        system.model.state_dict())
    _save(out_dir, rank, res)


def uneven_rank(rank, world, num_rays, out_dir):
    """One ``fit`` step of the tiny NeuS system at ``num_rays`` rays over
    the ranks: this rank's rays and buffer, the loss and the params."""
    system = _system(presets.tiny_neus_config(), os.path.join(out_dir, "s"))
    system.train_num_rays = num_rays
    metrics = []
    state = system.fit(max_steps=1, seed=2, log_every=1,
                       on_log=lambda step, m: metrics.append(m))
    _save(out_dir, rank, {
        "counts": system.rank_counts(system.capacity),
        "capacity": system.capacity,
        "train_capacity": system.train_options(0)["capacity"],
        "loss": metrics[0]["loss"], "skipped": system.skipped_updates,
        "step": state["step"],
        "params": bridge.to_jax_params(system.model.state_dict())})


class _ForceEscalation:
    """``render_chunk`` that records the buffer multiple of every call
    and, on rank ``force_rank``, reports at 1x that no ray fitted."""

    def __init__(self, system, force_rank):
        self.render, self.force = system.render_chunk, force_rank
        self.mults = []

    def __call__(self, state, rays, mult=1, **kw):
        self.mults.append(mult)
        res = self.render(state, rays, mult, **kw)
        if mult == 1 and sharding.rank() == self.force:
            res["ray_included"] = torch.zeros_like(res["ray_included"])
        return res


def neus_view64(ckpt, save_dir):
    """The tiny NeuS system from ``ckpt`` in float64, its validation
    split's view 0 rendered in float64."""
    neus = _system(presets.tiny_neus_config(), save_dir)
    state = neus.load_checkpoint(ckpt)
    neus.model.double()
    split = neus.datamodule.val()
    split.directions = split.directions.astype(np.float64)
    split.all_c2w = split.all_c2w.astype(np.float64)
    return neus.render_image(state, split, 0)


def eval_rank(rank, world, ckpt, out_dir):
    """Sharded renders: tiny NeuS view 0 from the JAX checkpoint, in
    float32, in float64, and in float32 with rank 1 forcing an
    escalation of every chunk (the multiples of every rank's
    ``render_chunk`` calls recorded); tiny split view 0 at stage 1 under
    the learned light, and in one multi-emitter pass under the learned
    light and a second one."""
    neus = _system(presets.tiny_neus_config(), os.path.join(out_dir, "n"))
    state = neus.load_checkpoint(ckpt)
    split = neus.datamodule.val()
    res = {"neus": neus.render_image(state, split, 0),
           "neus64": neus_view64(ckpt, os.path.join(out_dir, "n64"))}
    forced = _ForceEscalation(neus, force_rank=1)
    neus.render_chunk = forced
    res["neus_forced"] = neus.render_image(state, split, 0)
    res["mults"] = forced.mults
    res.update(split_renders(os.path.join(out_dir, "t")))
    _save(out_dir, rank, res)


def split_renders(save_dir):
    """Tiny split view 0 at stage 1: the learned light, the learned
    light with a second one in one multi-emitter pass, and the learned
    light with ``eval_mode: sphere_trace`` (the fully occupied grid of
    the init sends most rays to the volumetric residual)."""
    system = _system(presets.tiny_split_config(), save_dir)
    state = system.init_state(0)
    state["step"] = 20
    split = system.datamodule.val()
    base = system.model.emitter.base.detach()
    cfg = presets.tiny_split_config()
    cfg["model"]["eval_mode"] = "sphere_trace"
    surface = _system(cfg, save_dir + "-surface")
    surface.model.load_state_dict(system.model.state_dict())
    return {"split": system.render_image(state, split, 0),
            "split_multi": system.render_image(
                state, split, 0, emitter_base=[None, torch.roll(
                    base * 1.7 + 0.05, 1, -1)], n_relights=1),
            "split_surface": surface.render_image(state, split, 0),
            "split_surface_residual": surface.residual_rays}


def lifecycle_rank(rank, world, out_dir, seed, steps):
    """The tiny split system's ``fit`` over the ranks, with saves every 4
    steps and a validation every 6: uninterrupted for ``steps`` steps,
    and in two halves with a save, a new system and ``load_checkpoint``
    between them.  Records the whole state of both runs and every file
    this rank wrote (checkpoints and the saver's images)."""
    written = []
    save_npz, get_path = bridge.save_npz, saving.Saver.get_save_path

    def saving_npz(path, flat):
        written.append(os.path.relpath(path, out_dir))
        return save_npz(path, flat)

    def saver_path(self, filename):
        path = get_path(self, filename)
        written.append(os.path.relpath(path, out_dir))
        return path

    bridge.save_npz, saving.Saver.get_save_path = saving_npz, saver_path
    cfg = presets.tiny_split_config()
    cfg["trainer"]["save_every_n_steps"] = 4
    whole = _system(cfg, os.path.join(out_dir, "a"))
    state_a = whole.fit(max_steps=steps, seed=seed, log_every=0, val_every=6)
    first = _system(cfg, os.path.join(out_dir, "b"))
    mid = first.fit(max_steps=steps // 2, seed=seed, log_every=0)
    path = first.save_checkpoint(mid, os.path.join(out_dir, "mid.ckpt.npz"))
    resumed = _system(cfg, os.path.join(out_dir, "c"))
    resumed.init_state(0)  # other params, replaced by the load
    state = resumed.load_checkpoint(path)
    state_b = resumed.fit(max_steps=steps, seed=seed, state=state,
                          log_every=0)
    _save(out_dir, rank, {"whole": whole_state(whole, state_a),
                          "resumed": whole_state(resumed, state_b),
                          "written": written,
                          "skipped": whole.skipped_updates
                          + resumed.skipped_updates})


# --------------------------------------------------------------------- #
# sharding.py without a process group (one shard, no collective)
@pytest.mark.parametrize("num_rays,capacity,dp,want", [
    (30, 1 << 20, 4, (7, 262144)),  # tests/test_sharding.py's uneven case
    (3, 40, 4, (1, 16)),  # both floors
    (64, 16384, 2, (32, 8192)),
    (4096, 163840, 1, (4096, 163840))])
def test_per_rank_counts(num_rays, capacity, dp, want):
    # rise_sdf_tpu/systems/neus.py:234-236 and make_render_chunk
    assert want == (max(num_rays // dp, 1), max(capacity // dp, 16))
    assert sharding.per_rank_counts(num_rays, capacity, dp) == want
    assert sharding.per_rank_buffer(capacity, dp) == want[1]


def test_one_process_is_one_shard():
    assert sharding.data_shard_count() == 1 and sharding.rank() == 0
    assert sharding.is_main_process()
    t = [torch.arange(4.0)]
    sharding.all_reduce_mean_(t)
    assert torch.equal(t[0], torch.arange(4.0))
    outs = {"a": torch.ones(3, 2), "b": torch.tensor([True, False, True])}
    assert sharding.gather_rays(outs) is outs
    rays = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(sharding.shard_rays(rays, 2, 1), rays[3:])
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_rays(rays, 4, 0)
    scalars = {"x": 1.0}
    assert sharding.all_reduce_mean_scalars(scalars, "cpu") is scalars


def test_table_shard_count():
    assert sharding.table_shard_count(2, world=4) == 2
    assert sharding.table_shard_count(4, world=4, table_size=4096) == 4
    assert sharding.table_shard_count(1, world=4) == 1
    # one rank is one shard: the JAX launcher builds no mesh on one device
    assert sharding.table_shard_count(2, world=1) == 1
    assert sharding.table_shard_count(2) == 1  # no process group
    with pytest.raises(ValueError, match="does not divide"):
        sharding.table_shard_count(3, world=4)
    with pytest.raises(ValueError, match="does not split"):
        sharding.table_shard_count(4, world=8, table_size=2 ** 19 + 2)
    with pytest.raises(ValueError, match="at least 1"):
        sharding.table_shard_count(0, world=4)
    assert sharding.make_mesh(2) == sharding.Mesh(1, 1, 0, 0, None, None)


def test_backend_is_explicit():
    with pytest.raises(ValueError, match="nccl"):
        sharding.initialize_distributed("mpi", "file:///nonexistent")
