"""The data=2 x model=2 train step, eval and checkpoint of
``tiny_split_config`` at ``system.table_shards: 2``, over four gloo
ranks on the CPU (``tests/test_torch_table_shards_ranks.py::
split_steps_rank``, one spawn for the whole file).

The step is held against the port's own data=2 step computed in this
process, unsharded: each data index's batch and generator through a
one-process ``train_step`` from the same init, the gradients averaged
(``tests/test_torch_ddp.py`` holds that data-parallel step against the
JAX package's ``pmean``, and ``tests/test_torch_split_train.py`` the
one-process split step against JAX's).  The reduced gradients, a table
joined from its shards, at ``test_tp_grads_match_manual_dp``'s
tolerances (``tests/test_table_sharding.py``: rtol 2e-4 / atol 2e-6);
the replicated parameters bit-equal on all four ranks after three
steps and after a fourth step poisoned on rank 1 alone, which every
rank skips; the sharded validation render, volumetric and
sphere-traced, against the one-process render of the same checkpoint
(rtol 1e-4 / atol 2e-5, as ``test_tp_eval_render_matches``); the checkpoint written at tp=2 equal
to the ranks' gathered state, and a one-process checkpoint loaded at
tp=2 and saved again equal to it entry for entry, loaded back at tp=1
bit for bit and resumed there as the original resumes.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_table_shards_ranks as ranks_mod
from rise_sdf_tpu_torch import bridge, presets
from rise_sdf_tpu_torch.parallel import dryrun, sharding

WORLD, DP, TP = 4, 2, 2
STEPS = 3


def _tiny(save_dir):
    return ranks_mod._system(presets.tiny_split_config(), save_dir)


def _resume(path, save_dir, steps):
    """A one-process system from ``path`` and the state ``steps`` more
    ``fit`` steps give."""
    system = _tiny(save_dir)
    state = system.load_checkpoint(path)
    loaded = ranks_mod.whole_state(system, state)
    state = system.fit(max_steps=int(state["step"]) + steps, seed=3,
                       state=state, log_every=0)
    return loaded, ranks_mod.whole_state(system, state)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("table_shards_train"))
    draw = _tiny(os.path.join(tmp, "draw"))
    local_rays = max(draw.train_num_rays // DP, 1)
    data = draw.device_data(draw.datamodule.train())
    batches = [[{k: v.numpy() for k, v in draw.sample_batch(
        torch.Generator().manual_seed(100 + 10 * s + d), data,
        num_rays=local_rays).items()} for d in range(DP)]
        for s in range(STEPS)]
    seeds = [[200 + 10 * s + d for d in range(DP)] for s in range(STEPS)]
    # a one-process state two steps into stage 1 (the stage flips at
    # 10; at the init the sphere-init MLP gives the table no gradient),
    # saved by one process
    one = _tiny(os.path.join(tmp, "one"))
    state = one.fit(max_steps=one.model.split_sum_kick_in_step + 2, seed=5,
                    log_every=0)
    ckpt = one.save_checkpoint(state, os.path.join(tmp, "one.ckpt.npz"))
    dryrun.spawn(ranks_mod.split_steps_rank, WORLD, "gloo",
                 args=(batches, seeds, ckpt, tmp))
    got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]

    # the reference: each data index's first step in one process, averaged
    grads = []
    for d in range(DP):
        ref = _tiny(os.path.join(tmp, f"ref{d}"))
        # a data shard's buffer, as a rank of DP takes
        ref.rank_counts = lambda cap, n=ref.train_num_rays: \
            sharding.per_rank_counts(n, cap, DP)
        st = ref.load_checkpoint(ckpt)
        ref.train_step(st, ranks_mod._batch(batches[0][d]),
                       torch.Generator().manual_seed(seeds[0][d]))
        grads.append({bridge.jax_path(k): p.grad.numpy().copy()
                      for k, p in ref.model.named_parameters()})
    mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
    return {"ranks": got, "mean": mean, "ckpt": ckpt, "tmp": tmp}


def _full(ranks, key, data_index=0):
    """Rank ``data_index * TP + m``'s ``key`` entries, tables joined."""
    return bridge.gather_params([ranks[data_index * TP + m][key]
                                 for m in range(TP)])


def test_mesh_and_losses(run):
    for r, res in enumerate(run["ranks"]):
        assert res["mesh"] == (DP, TP, r // TP, r % TP)
        assert res["skipped"] == [0.0] * STEPS
        assert np.all(np.isfinite(res["loss"]))
        # the loss is averaged over the world: the same on every rank
        assert res["loss"] == run["ranks"][0]["loss"]


def test_reduced_grads_match_the_one_process_mean(run):
    ranks, want = run["ranks"], run["mean"]
    for d in range(DP):
        post = bridge.gather_params([
            {bridge.jax_path(k): v.numpy()
             for k, v in ranks[d * TP + m]["post"].items()}
            for m in range(TP)])
        assert sorted(post) == sorted(want)
        for k in want:
            np.testing.assert_allclose(post[k], want[k], rtol=2e-4,
                                       atol=2e-6, err_msg=k)


def test_table_grads_reduced_over_the_data_group(run):
    """A table shard's gradient is the mean of the data group's own
    (bit for bit at two ranks); the model group's shards differ."""
    ranks = run["ranks"]
    key = "geometry.encoding.encoding.table"
    for m in range(TP):
        a, b = ranks[m], ranks[TP + m]
        assert torch.equal(a["post"][key],
                           (a["pre"][key] + b["pre"][key]) / 2)
        assert torch.equal(a["post"][key], b["post"][key])
    assert not torch.equal(ranks[0]["post"][key], ranks[1]["post"][key])
    assert all(bool(ranks[m]["post"][key].any()) for m in range(TP))


def test_replicated_params_bit_equal_across_ranks(run):
    ranks = run["ranks"]
    for key in ("params", "params_after_poison"):
        for k, v in ranks[0][key].items():
            for r in range(1, WORLD):
                if bridge.is_table(k, v.ndim):
                    # a shard equals its data group's copy
                    if r % TP == 0:
                        np.testing.assert_array_equal(ranks[r][key][k], v,
                                                      err_msg=k)
                else:
                    np.testing.assert_array_equal(ranks[r][key][k], v,
                                                  err_msg=k)


def test_poisoned_rank_skips_the_update_on_every_rank(run):
    for res in run["ranks"]:
        assert res["poisoned_skipped"] == 1.0 and res["skipped_updates"] == 1
        for k in res["params"]:
            np.testing.assert_array_equal(res["params_after_poison"][k],
                                          res["params"][k], err_msg=k)


def test_checkpoint_is_the_gathered_state(run):
    """The tp=2 checkpoint is the unsharded run's file: every entry the
    ranks' state, the tables joined from the shards."""
    saved = bridge.load_npz(os.path.join(run["tmp"], "trained.ckpt.npz"))
    want = _full(run["ranks"], "state")
    assert sorted(saved) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(saved[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["volume", "sphere_trace"])
def test_sharded_render_matches_one_process(run, mode):
    cfg = presets.tiny_split_config()
    if mode == "sphere_trace":
        cfg["model"]["eval_mode"] = mode
    system = ranks_mod._system(cfg, os.path.join(run["tmp"], mode))
    state = system.load_checkpoint(os.path.join(run["tmp"],
                                                "trained.ckpt.npz"))
    want = system.render_image(state, system.datamodule.val(), 0)
    key = "view" if mode == "volume" else "view_surface"
    for res in run["ranks"]:
        if mode == "sphere_trace":
            # every rank re-renders the same residual rays
            assert res["surface_residual"] == system.residual_rays
        got = res[key]
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["ray_included"],
                                      want["ray_included"])
        for k in ("comp_rgb_full", "comp_rgb_phys_full", "opacity", "depth",
                  "comp_normal"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=2e-5, err_msg=k)


def test_checkpoint_round_trip_across_table_shards(run):
    """A one-process checkpoint loaded at tp=2 and saved again is the same
    file, entry for entry; each rank loaded its rows of it; at tp=1 it
    loads back bit for bit and resumes as the original."""
    tmp = run["tmp"]
    orig = bridge.load_npz(run["ckpt"])
    resaved = bridge.load_npz(os.path.join(tmp, "resaved.ckpt.npz"))
    assert sorted(resaved) == sorted(orig)
    for k in orig:
        np.testing.assert_array_equal(resaved[k], orig[k], err_msg=k)
    for r, res in enumerate(run["ranks"]):
        want = bridge.shard_params(orig, TP, r % TP)
        for k, v in res["loaded"].items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    a_loaded, a = _resume(run["ckpt"], os.path.join(tmp, "ra"), 2)
    b_loaded, b = _resume(os.path.join(tmp, "resaved.ckpt.npz"),
                          os.path.join(tmp, "rb"), 2)
    for k in orig:
        np.testing.assert_array_equal(b_loaded[k], orig[k], err_msg=k)
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
