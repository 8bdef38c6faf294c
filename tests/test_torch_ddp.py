"""Data-parallel training over two gloo ranks on the CPU, held against
the JAX package's manual pmean on ``tiny_neus_config``
(``tests/test_sharding.py::test_sharded_step_matches_manual_pmean``).

Each rank's batch is drawn once here and given to both sides.  The JAX
side takes per-device gradients of ``forward_loss`` at the per-device
buffer, averages them and applies one optax update per step; the port
runs the same batches through ``train_step`` on two gloo ranks
(``generator=None``).  Loss, gradients and three Adam steps are held at
the tolerances of ``tests/test_torch_neus.py``; the ranks' params must
be bit-equal, and the all-reduced gradients bit-equal to the mean of
the two ranks' own (a sum of two is the same in either order).

Both sides run in float64 (JAX under ``jax.enable_x64``): a rank's 32
rays put the float32 global transmittance scan's rounding (ROADMAP.md,
Queue 3) at up to 3.4e-3 of a gradient tensor's largest entry on the
port's side and 1.6e-2 on JAX's against float64, measured on such
batches, while the two sides agree to 1.5e-5 in float64.  A
fourth step poisoned on rank 1 skips the update on both ranks.  Also:
an uneven 30-ray step over four ranks (``tests/test_sharding.py:
104-119``).  Ranks are spawned processes (``parallel/dryrun.spawn``)
running the workers of ``tests/test_torch_ddp_ranks.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_ddp_ranks as ranks_mod
from test_torch_neus import _shell_grid
from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import presets as jpresets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu_torch import bridge, datasets, presets, systems
from rise_sdf_tpu_torch.parallel import dryrun

WORLD = 2
STEPS = 3


def _load(out, n):
    # files the spawned ranks of this test wrote
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(n)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX reference and the two ranks' records."""
    tmp = str(tmp_path_factory.mktemp("ddp"))
    jcfg = jpresets.tiny_neus_config()
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                         save_dir=os.path.join(tmp, "jax"))
    jstate = jsys.init_state(0)
    ckpt = jsys.save_checkpoint(jstate, os.path.join(tmp, "jax.ckpt.npz"))
    cfg = presets.tiny_neus_config()
    tsys = systems.make(cfg["system"]["name"], cfg,
                        datasets.make(cfg["dataset"]["name"], cfg["dataset"]),
                        save_dir=os.path.join(tmp, "draw"), device="cpu")
    local_rays = max(tsys.train_num_rays // WORLD, 1)
    local_cap = max(tsys.capacity // WORLD, 16)
    data = tsys.device_data(tsys.datamodule.train())
    batches = [[{k: v.numpy() for k, v in tsys.sample_batch(
        torch.Generator().manual_seed(100 + 10 * s + r), data,
        num_rays=local_rays).items()} for r in range(WORLD)]
        for s in range(STEPS)]
    grid = _shell_grid()
    dryrun.spawn(ranks_mod.neus_steps_rank, WORLD, "gloo",
                 args=(ckpt, batches, grid, tmp))
    got = _load(tmp, WORLD)

    with jax.enable_x64():
        def loss_fn(p, batch, step):
            return jsys.forward_loss(p, batch, jnp.asarray(grid), step, None,
                                     None, local_cap)

        grads_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), jstate["params"])
        opt_state = jsys.tx.init(params)
        losses, grad0 = [], None
        for s in range(STEPS):
            out = [grads_fn(params, {k: jnp.asarray(v, jnp.float64)
                                     for k, v in b.items()}, s)
                   for b in batches[s]]
            losses.append(np.mean([float(l) for (l, _), _ in out]))
            mean = jax.tree_util.tree_map(lambda *g: sum(g) / len(g),
                                          *[g for _, g in out])
            if grad0 is None:
                grad0 = bridge.flatten_params(mean)
            updates, opt_state = jsys.tx.update(mean, opt_state, params)
            params = optax.apply_updates(params, updates)
        params = bridge.flatten_params(params)
    return {"ranks": got, "losses": losses, "grad0": grad0,
            "params": params}


def test_loss_matches_jax_pmean(run):
    for r in run["ranks"]:
        assert r["skipped"] == [0.0] * STEPS
        np.testing.assert_allclose(r["loss"], run["losses"], rtol=1e-4)


def test_reduced_grads_match_jax_mean(run):
    got = {bridge.jax_path(k): v.numpy()
           for k, v in run["ranks"][0]["post"].items()}
    want = run["grad0"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want[k]).max()),
                                   err_msg=k)


def test_reduced_grads_are_the_ranks_mean_bit_for_bit(run):
    a, b = run["ranks"]
    differ = 0
    for k, post in a["post"].items():
        pa = a["pre"].get(k, torch.zeros_like(post))
        pb = b["pre"].get(k, torch.zeros_like(post))
        differ += not torch.equal(pa, pb)
        assert torch.equal(post, (pa + pb) / 2), k
        assert torch.equal(post, b["post"][k]), k
    assert differ >= 10  # the ranks' own gradients differ


def test_three_adam_steps_match_jax(run):
    got, want, grad0 = run["ranks"][0]["params"], run["params"], run["grad0"]
    compared = 0
    for k in want:
        # as tests/test_torch_neus.py::test_three_adam_steps_match_jax
        sel = np.abs(grad0[k]) > 1e-6
        compared += int(sel.sum())
        np.testing.assert_allclose(got[k][sel], want[k][sel], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert compared > 500


def test_params_bit_equal_across_ranks(run):
    a, b = run["ranks"]
    for key in ("params", "params_after_poison"):
        for k in a[key]:
            np.testing.assert_array_equal(a[key][k], b[key][k], err_msg=k)


def test_poisoned_rank_skips_the_update_on_every_rank(run):
    for r in run["ranks"]:
        assert r["poisoned_skipped"] == 1.0 and r["skipped_updates"] == 1
        for k in r["params"]:
            np.testing.assert_array_equal(r["params_after_poison"][k],
                                          r["params"][k], err_msg=k)


def test_uneven_ray_count_over_four_ranks(tmp_path):
    dryrun.spawn(ranks_mod.uneven_rank, 4, "gloo", args=(30, str(tmp_path)))
    got = _load(str(tmp_path), 4)
    for r in got:
        # 30 // 4 rays and a quarter of the buffer each
        assert r["counts"] == (7, max(r["capacity"] // 4, 16))
        assert r["train_capacity"] == r["counts"][1]
        assert np.isfinite(r["loss"]) and r["skipped"] == 0
        assert r["step"] == 1
        for k in r["params"]:
            np.testing.assert_array_equal(r["params"][k],
                                          got[0]["params"][k], err_msg=k)
