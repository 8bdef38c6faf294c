"""A run's lifecycle over data-parallel ranks on the CPU (gloo).

* ``fit`` over two ranks with saves every 4 steps and a validation every
  6 writes each checkpoint and image once, from rank 0 (rank 1 writes
  nothing).
* A two-rank run resumed from its checkpoint replays the uninterrupted
  two-rank run bit for bit (every param, Adam moment and count, the
  schedule's count, ``occs``, ``occ_binary``), on ``tiny_split_config``
  across its stage flip at step 10, and the two ranks' states are
  bit-equal.
* A ``fit`` in a process group of one rank equals the one-process
  ``fit`` bit for bit.
* ``python -m torch.distributed.run --nproc_per_node 2 -m
  rise_sdf_tpu_torch.launch --preset tiny_neus_config --device cpu
  --train`` exits 0 with one trial directory and one set of files.
* ``chip_smoke.py`` phase 11's window (``measure.ddp_window``) on two
  CPU ranks at ``tiny_split_config``: the all-reduced table gradient
  within one ulp of the ranks' float64 mean, the ranks' params and grid
  bit-equal, the sharded validation view within 2e-3 of the one-process
  render of rank 0's checkpoint.
"""

import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

import test_torch_ddp_ranks as ranks_mod
from rise_sdf_tpu_torch import datasets, measure, presets, systems
from rise_sdf_tpu_torch.parallel import dryrun, sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_two_rank_lifecycle(tmp_path):
    out = str(tmp_path)
    dryrun.spawn(ranks_mod.lifecycle_rank, 2, "gloo",
                 args=(out, 7, STEPS))
    # files the spawned ranks of this test wrote
    a, b = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]
    assert a["skipped"] == b["skipped"] == 0
    # resumed == uninterrupted, on each rank; the ranks agree
    _assert_same(a["resumed"], a["whole"])
    _assert_same(b["resumed"], b["whole"])
    _assert_same(b["whole"], a["whole"])
    assert int(a["whole"]["step"]) == STEPS
    # every save and image once, from rank 0: run a saves after steps 4
    # and 8 and validates after step 6 (the state of step 7), run b
    # saves after step 4, then at its end and the mid-run file, run c
    # after step 8
    assert b["written"] == []
    assert a["written"] == [
        "a/ckpt/latest.ckpt.npz", "a/it7-envmap.exr", "a/it7-0.png",
        "a/ckpt/latest.ckpt.npz", f"a/ckpt/step_{STEPS}.ckpt.npz",
        "b/ckpt/latest.ckpt.npz", f"b/ckpt/step_{STEPS // 2}.ckpt.npz",
        "mid.ckpt.npz", "c/ckpt/latest.ckpt.npz",
        f"c/ckpt/step_{STEPS}.ckpt.npz"]
    for name in a["written"]:
        assert os.path.exists(os.path.join(out, name)), name


def _fit(tmp, seed):
    cfg = presets.tiny_neus_config()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    system = systems.make(cfg["system"]["name"], cfg, dm, save_dir=tmp,
                          device="cpu")
    state = system.fit(max_steps=6, seed=seed, log_every=0)
    return ranks_mod.whole_state(system, state)


def test_world_size_one_fit_equals_one_process_fit(tmp_path):
    one = _fit(str(tmp_path / "one"), 3)
    sharding.initialize_distributed(
        "gloo", f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        assert sharding.data_shard_count() == 1 and dist.is_initialized()
        group = _fit(str(tmp_path / "group"), 3)
    finally:
        dist.destroy_process_group()
    _assert_same(group, one)


def test_torchrun_cli_two_ranks(tmp_path):
    exp = tmp_path / "exp"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "rise_sdf_tpu_torch.launch",
         "--preset", "tiny_neus_config", "--device", "cpu", "--train",
         "--exp_dir", str(exp)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    trials = os.listdir(exp / "exp")
    assert len(trials) == 1, trials
    trial = exp / "exp" / trials[0]
    files = sorted(os.path.relpath(os.path.join(d, f), trial)
                   for d, _, fs in os.walk(trial) for f in fs)
    assert files == ["ckpt/step_25.ckpt.npz", "config/parsed.json",
                     "save/it25-mc32.ply", "save/it25-test.gif",
                     "save/it25-test/0.png", "save/it25-test/1.png",
                     "save/it25-test/2.png"]
    assert res.stdout.count("test/psnr") == 2  # both ranks tested


def test_measure_ddp_window_on_two_cpu_ranks(tmp_path):
    cfg = presets.tiny_split_config()
    ranks = measure.ddp_window(2, "gloo", str(tmp_path), 16, cfg=cfg,
                               device="cpu")
    for r in ranks:
        assert r["world"] == 2 and r["rays_per_rank"] == 32
        assert r["steps"] == 16 and r["skipped"] == 0
        assert np.all(np.isfinite(r["losses"]))
        assert r["grad_check"]["over_bound"] == 0
        assert r["grad_check"]["max_rel_err"] <= 2.0 ** -24
        assert r["grad_check"]["max_abs_mean"] > 0
        assert r["params_equal"]
        assert np.isfinite(r["val"]["psnr"])
        assert np.isfinite(r["val"]["phys_psnr"])
    assert ranks[0]["losses"] == ranks[1]["losses"]  # the reduced loss
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    one = systems.make(cfg["system"]["name"], cfg, dm,
                       save_dir=str(tmp_path / "one"), device="cpu")
    state = one.load_checkpoint(ranks[0]["ckpt"])
    assert state["step"] == measure.SPLIT_STAGE1_STEP + 16
    want = one.render_image(state, dm.val(), 0)
    got = np.load(tmp_path / "val_view0.npz")
    for k in ("comp_rgb_full", "comp_rgb_phys_full", "opacity", "depth"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-3, err_msg=k)
