"""Sharded eval over two gloo ranks on the CPU, and the flagship graph's
data-parallel step.

* The port's sharded NeuS view (each chunk's rays split over the ranks,
  each rank's buffer ``max(base // 2, 16)``, the outputs gathered) is
  held against the JAX package's ``make_render_chunk(mesh=get_mesh(2))``
  on the conftest's virtual CPU devices, the same per-device buffer on
  both sides, at 1e-4 (the forward parity tolerance of
  ``tests/test_torch_neus.py``), both in float64 (JAX under
  ``jax.enable_x64``): on this view the float32 global transmittance
  scan (ROADMAP.md, Queue 3) already puts the two packages' one-device
  float32 renders 2.2e-4 apart in colour and 1.2e-3 in depth, where in
  float64 they agree to 2e-7.  The sharded float32 view is held against
  the port's one-process view at 2e-3, the bound of
  ``tests/test_sharded_eval.py``.
* A chunk that overflows on one rank alone (forced on rank 1) is
  escalated to 2x on both ranks together, and the image stays the same.
* The tiny split view at stage 1, under the learned light, in one
  multi-emitter pass with a second light, and in surface mode
  (``eval_mode: sphere_trace``: the surface chunk sharded, its
  volumetric residual on every rank), sharded against one process at
  2e-3.
* ``dryrun_multichip(2, "cpu", "gloo")``: one stage-1 step of
  ``tiny_split_config`` (mips, secondary pass, hybrid FD, curvature
  probe) over two ranks, its all-reduced gradients bit-equal to the
  mean of the ranks' own and the ranks' params bit-equal
  (``tests/test_sharding.py:122-136``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ddp_ranks as ranks_mod
from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import presets as jpresets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.parallel import get_mesh
from rise_sdf_tpu_torch import datasets, presets, systems
from rise_sdf_tpu_torch.parallel import dryrun

WORLD = 2
KEYS = ("comp_rgb_full", "comp_normal", "opacity", "depth")
SPLIT_KEYS = ("comp_rgb_full", "comp_rgb_phys_full", "opacity", "depth")


def _port(cfg, save_dir):
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    return systems.make(cfg["system"]["name"], cfg, dm, save_dir=save_dir,
                        device="cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ddp_eval"))
    jcfg = jpresets.tiny_neus_config()
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                         save_dir=os.path.join(tmp, "jax"))
    jstate = jsys.init_state(0)
    ckpt = jsys.save_checkpoint(jstate, os.path.join(tmp, "jax.ckpt.npz"))
    dryrun.spawn(ranks_mod.eval_rank, WORLD, "gloo", args=(ckpt, tmp))
    # files the spawned ranks of this test wrote
    got = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    assert len(jax.devices()) >= WORLD
    with jax.enable_x64():
        state = dict(jstate, params=jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), jstate["params"]))
        split = jsys.datamodule.val()
        split.directions = np.asarray(split.directions, np.float64)
        split.all_c2w = np.asarray(split.all_c2w, np.float64)
        want = jsys.render_image(state, split, 0, jsys.make_render_chunk(
            mesh=get_mesh(WORLD)))
    neus = _port(presets.tiny_neus_config(), os.path.join(tmp, "one"))
    one = neus.render_image(neus.load_checkpoint(ckpt),
                            neus.datamodule.val(), 0)
    return {"ranks": got, "jax": want, "one": one,
            "split_one": ranks_mod.split_renders(os.path.join(tmp, "s1"))}


def test_sharded_neus_view_matches_jax_mesh(run):
    for r in run["ranks"]:
        assert r["neus64"]["ray_included"].all()
        for k in KEYS:
            assert r["neus64"][k].dtype == np.float64
            np.testing.assert_allclose(r["neus64"][k],
                                       np.asarray(run["jax"][k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_sharded_neus_view_matches_one_process(run):
    a, b = run["ranks"]
    for k in KEYS:
        np.testing.assert_array_equal(a["neus"][k], b["neus"][k], err_msg=k)
        np.testing.assert_allclose(a["neus"][k], run["one"][k], atol=2e-3,
                                   err_msg=k)


def test_escalation_is_taken_on_every_rank_together(run):
    chunks = 1024 // 256  # the 32 x 32 view in chunks of ray_chunk rays
    for r in run["ranks"]:
        assert r["mults"] == [1, 2] * chunks
        for k in KEYS:
            np.testing.assert_allclose(r["neus_forced"][k], r["neus"][k],
                                       atol=2e-3, err_msg=k)


@pytest.mark.parametrize("view", ["split", "split_multi", "split_surface"])
def test_sharded_split_view_matches_one_process(run, view):
    keys = SPLIT_KEYS + (("relight0/comp_rgb_phys_full",)
                         if view == "split_multi" else ())
    for r in run["ranks"]:
        assert r[view]["ray_included"].all()
        for k in keys:
            np.testing.assert_allclose(r[view][k], run["split_one"][view][k],
                                       atol=2e-3, err_msg=k)
        if view == "split_surface":
            # every rank re-renders the same residual, unsharded
            n = r[view]["ray_included"].size
            assert 0 < r["split_surface_residual"] < n
            assert r["split_surface_residual"] \
                == run["split_one"]["split_surface_residual"]


def test_dryrun_multichip_two_ranks():
    res = dryrun.dryrun_multichip(WORLD, "cpu", "gloo")
    assert np.isfinite(res["loss"])
    a, b = res["ranks"]
    differ = 0
    for k, post in a["post"].items():
        differ += not torch.equal(a["pre"][k], b["pre"][k])
        assert torch.equal(post, (a["pre"][k] + b["pre"][k]) / 2), k
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert differ >= 10
