"""Rank workers of the table-sharding tests (``tests/test_torch_table_
shards*.py``) and the tests of row sharding that need no process group
and no JAX: the absent-row rule of the kernels' plain versions,
``table_shard_count``, ``bridge.shard_params`` / ``gather_params`` and
a sharded encoding's refusal to look up without its model group.

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
from rise_sdf_tpu_torch.ops import gather, scatter, scatter_sorted
from rise_sdf_tpu_torch.ops.hashgrid import HashGridEncoding
from rise_sdf_tpu_torch.parallel import sharding

# tests/test_table_sharding.py:25-35
SMALL = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
         "log2_hashmap_size": 8, "base_resolution": 4,
         "per_level_scale": 1.6}
PROBE_AXES = (0, 0, 1, 1, 2, 2)


def _save(out_dir, rank, res):
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _system(cfg, save_dir):
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    return systems.make(cfg["system"]["name"], cfg, dm, save_dir=save_dir,
                        device="cpu")


def whole_state(system, state):
    """Every tensor of the training state, by JAX path (the table entries
    this rank's rows)."""
    flat = bridge.to_jax_state(system.model, system.optimizer,
                               system.scheduler)
    flat["occs"] = state["occs"].numpy().copy()
    flat["occ_binary"] = state["occ_binary"].numpy().copy()
    flat["step"] = np.asarray(state["step"])
    return flat


# --------------------------------------------------------------------- #
def _encodes(enc, x, probes, cot):
    """The three encodes of ``enc`` at ``x`` and their table gradients
    under the cotangents ``cot`` (a sum of products with each output)."""
    res = {}
    enc.table.grad = None
    f = enc(x)
    (f * cot["forward"]).sum().backward()
    res["forward"], res["forward_grad"] = f.detach(), enc.table.grad.clone()
    enc.table.grad = None
    f, jac = enc.encode_with_grad(x)
    sum((o * c).sum() for o, c in zip((f,) + jac, cot["with_grad"])
        ).backward()
    res["with_grad"] = [o.detach() for o in (f,) + jac]
    res["with_grad_grad"] = enc.table.grad.clone()
    enc.table.grad = None
    p = enc.encode_axis_probes(x, probes, PROBE_AXES)
    (p * cot["probes"]).sum().backward()
    res["probes"], res["probes_grad"] = p.detach(), enc.table.grad.clone()
    # the position gradient (every shard's part summed) and a loss on it,
    # whose table gradient takes the double backward
    enc.table.grad = None
    xg = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad((enc(xg) * cot["forward"]).sum(), xg,
                                create_graph=True)
    (gx ** 2).sum().backward()
    res["x_grad"], res["x_grad_grad"] = gx.detach(), enc.table.grad.clone()
    enc.table.grad = None
    torch.use_deterministic_algorithms(True)
    try:
        (enc(x) * cot["forward"]).sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)
    res["forward_grad_det"] = enc.table.grad.clone()
    return res


def encode_rank(rank, world, table, x, probes, cot, out_dir):
    """The small encoding's three encodes and their table gradients at
    ``table_shards`` 2 (data=2 x model=2) and 4 (data=1 x model=4), this
    rank's shard sliced from the full ``table``; for each, the mesh, the
    outputs and this rank's rows of each gradient."""
    res = {}
    t = torch.from_numpy
    for tp in (2, 4):
        mesh = sharding.make_mesh(tp, table_size=2 ** SMALL[
            "log2_hashmap_size"])
        enc = HashGridEncoding(3, SMALL)
        with torch.no_grad():
            enc.table.copy_(t(table))
        enc.shard_table(tp, mesh.model_index, mesh.model_group)
        out = _encodes(enc, t(x), t(probes),
                       {k: [t(c) for c in v] if isinstance(v, list)
                        else t(v) for k, v in cot.items()})
        out["mesh"] = mesh[:4]
        res[tp] = out
    _save(out_dir, rank, res)


# --------------------------------------------------------------------- #
def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def split_steps_rank(rank, world, batches, seeds, ckpt, out_dir):
    """The tiny split config at ``table_shards: 2`` over four ranks
    (data=2 x model=2) from the one-process stage-1 checkpoint ``ckpt``:
    the state as loaded (``loaded``) and saved again at once
    (``resaved.ckpt.npz``); one ``train_step`` per entry of ``batches``
    (this rank's data index's batch, a generator seeded from
    ``seeds``), the first step's gradients before (``pre``) and after
    (``post``) the reductions, the params after the steps; a step whose
    batch is poisoned on rank 1 alone; the state and its checkpoint
    (``trained.ckpt.npz``); the validation view 0, sharded, volumetric
    and sphere-traced (``eval_mode: sphere_trace``)."""
    cfg = presets.tiny_split_config()
    cfg["system"]["table_shards"] = 2
    system = _system(cfg, os.path.join(out_dir, "s"))
    mesh = system.mesh
    system.init_state(1)  # other params, replaced by the load
    state = system.load_checkpoint(ckpt)
    res = {"mesh": mesh[:4], "loss": [], "skipped": [],
           "loaded": whole_state(system, state)}
    system.save_checkpoint(state, os.path.join(out_dir, "resaved.ckpt.npz"))
    pre = {}

    def first_grad(p, name):  # this rank's own, before the reductions
        if name not in pre:
            pre[name] = p.grad.clone()

    for name, p in system.model.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, name=name: first_grad(p, name))
    for i, per_data in enumerate(batches):
        gen = torch.Generator().manual_seed(seeds[i][mesh.data_index])
        aux = system.train_step(state, _batch(per_data[mesh.data_index]),
                                gen)
        res["loss"].append(float(aux["loss"]))
        res["skipped"].append(float(aux["skipped_nonfinite"]))
        if i == 0:
            res["pre"] = dict(pre)
            res["post"] = {k: p.grad.clone()
                           for k, p in system.model.named_parameters()}
    res["params"] = bridge.to_jax_params(system.model.state_dict())
    batch = _batch(batches[0][mesh.data_index])
    if rank == 1:
        batch["rgb"] = torch.full_like(batch["rgb"], float("nan"))
    aux = system.train_step(state, batch, torch.Generator().manual_seed(7))
    res["poisoned_skipped"] = float(aux["skipped_nonfinite"])
    res["skipped_updates"] = system.skipped_updates
    res["params_after_poison"] = bridge.to_jax_params(
        system.model.state_dict())
    res["state"] = whole_state(system, state)
    system.save_checkpoint(state, os.path.join(out_dir, "trained.ckpt.npz"))
    res["view"] = system.render_image(state, system.datamodule.val(), 0)
    cfg["model"]["eval_mode"] = "sphere_trace"
    surface = _system(cfg, os.path.join(out_dir, "t"))
    surface.model.load_state_dict(system.model.state_dict())
    res["view_surface"] = surface.render_image(state,
                                               surface.datamodule.val(), 0)
    res["surface_residual"] = surface.residual_rays
    _save(out_dir, rank, res)


# --------------------------------------------------------------------- #
# no process group
def test_absent_rows_gather_zeros():
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((10, 2), generator=gen)
    idx = torch.tensor([3, -1, 9, -1, 0, 3, -7, 2], dtype=torch.int32)
    got = gather.gather_rows(table, idx)
    want = table[idx.long().clamp(min=0)] * (idx >= 0)[:, None]
    assert torch.equal(got, want)
    assert not got[idx < 0].any()
    # rows of 16-byte vectors (the baked SDF's 8-wide rows)
    wide = torch.randn((10, 8), generator=gen)
    got = gather.gather_rows(wide, idx)
    assert torch.equal(got[idx >= 0], wide[idx[idx >= 0].long()])
    assert not got[idx < 0].any()


def test_absent_rows_dropped_by_scatter():
    gen = torch.Generator().manual_seed(1)
    idx = torch.randint(-3, 6, (400,), generator=gen, dtype=torch.int32)
    vals = torch.randn((400, 2), generator=gen)
    vals[idx < 0] = float("nan")  # an absent row's value reaches nothing
    keep = idx >= 0
    want = torch.zeros((6, 2)).index_add_(0, idx[keep].long(), vals[keep])
    assert torch.equal(scatter.scatter_add(idx, vals, 6, 8), want)
    assert torch.equal(scatter.scatter_add_plain(idx, vals, 6), want)
    assert torch.equal(scatter.scatter_add(idx[:0], vals[:0], 6),
                       torch.zeros((6, 2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_absent_rows_dropped_by_sorted_scatter(dtype):
    """K2's plain version drops absent rows from the range, the buckets
    and the sums alike: the same bits as a call without them, but for M
    (the bound's bit length), which counts them."""
    gen = torch.Generator().manual_seed(2)
    n = 600
    idx = torch.randint(0, 7, (n,), generator=gen, dtype=torch.int32)
    vals = torch.randn((n, 2), generator=gen, dtype=dtype)
    absent = torch.rand(n, generator=gen) < 0.4
    idx_a = torch.where(absent, -1, idx).to(torch.int32)
    # absent values far outside the present range and not finite
    vals_a = vals.clone()
    vals_a[absent] = torch.tensor([1e30, float("inf")], dtype=dtype)
    got = scatter_sorted.scatter_add_sorted(idx_a, vals_a, 7, 8)
    # the same M with the absent entries as zeros at row 0 of a table
    # whose row 0 is then the present entries' alone
    zero = torch.where(absent[:, None], 0, vals)
    want = scatter_sorted.scatter_add_sorted_plain(idx_a.clamp(min=0),
                                                   zero, 7)
    assert torch.equal(got, want)
    exact = torch.zeros((7, 2), dtype=torch.float64).index_add_(
        0, idx[~absent].long(), vals[~absent].double())
    torch.testing.assert_close(got.double(), exact, rtol=0,
                               atol=1e-6 if dtype == torch.float32
                               else 1e-14)
    none = torch.full((n,), -1, dtype=torch.int32)
    assert torch.equal(scatter_sorted.scatter_add_sorted(none, vals_a, 7),
                       torch.zeros((7, 2), dtype=dtype))


def test_bridge_shards_and_gathers_tables():
    rng = np.random.default_rng(3)
    flat = {"params/geometry/encoding/table": rng.standard_normal(
                (3, 16, 2)).astype(np.float32),
            bridge.MU + "geometry/encoding/table": rng.standard_normal(
                (3, 16, 2)),
            "params/geometry/mlp/layers/0/v": rng.standard_normal((4, 4)),
            "opt_state/0/count": np.asarray(5, np.int32)}
    shards = [bridge.shard_params(flat, 4, m) for m in range(4)]
    for m, s in enumerate(shards):
        for k, v in s.items():
            if k.endswith("table"):
                np.testing.assert_array_equal(
                    v, flat[k][:, 4 * m:4 * m + 4], err_msg=k)
            else:
                assert v is flat[k], k
    back = bridge.gather_params(shards)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(ValueError, match="do not split"):
        bridge.shard_params(flat, 3, 0)


def test_sharded_encoding_refuses_a_lookup_without_its_group():
    enc = HashGridEncoding(3, SMALL)
    full = enc.table.detach().clone()
    enc.shard_table(2, 1, None)
    assert tuple(enc.table.shape) == (4, 128, 2)
    assert torch.equal(enc.table.detach(), full[:, 128:])
    x = torch.rand((8, 3), generator=torch.Generator().manual_seed(4))
    with pytest.raises(RuntimeError, match="without its model group"):
        enc(x)
    with pytest.raises(RuntimeError, match="without its model group"):
        enc.encode_with_grad(x)
    # the full table read whole, with no collective, is the unsharded
    # encode
    plain = HashGridEncoding(3, SMALL)
    with torch.no_grad():
        plain.table.copy_(full)
    with enc.unsharded(full):
        assert torch.equal(enc(x), plain(x))
    with pytest.raises(ValueError, match="split"):
        HashGridEncoding(3, SMALL).shard_table(3, 0, None)
    # a shard's init is its rows of the full table's draw
    a, b = HashGridEncoding(3, SMALL), HashGridEncoding(3, SMALL)
    b.shard_table(2, 1, None)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    assert torch.equal(b.table.detach(), a.table.detach()[:, 128:])
