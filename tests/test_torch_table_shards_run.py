"""``system.table_shards`` from the entry points a user calls, on gloo
ranks on the CPU.

* ``dryrun_multichip(4, "cpu", "gloo")`` takes data=2 x model=2, as
  ``__graft_entry__.dryrun_multichip`` does at four devices: one
  stage-1 step of ``tiny_split_config``, each table shard's gradient
  the mean of its data group's own, every other gradient the world's
  mean, the replicated parameters bit-equal on the four ranks.
* ``python -m torch.distributed.run --nproc_per_node 2 -m
  rise_sdf_tpu_torch.launch --preset tiny_neus_config --device cpu
  --train system.table_shards=2`` trains, tests and exports on
  data=1 x model=2, writes one trial directory with one set of files,
  and its checkpoint holds the whole table.
* ``measure.ddp_window`` (``--preset ddp --table-shards 2``) and
  ``measure.table_shard_window`` (``chip_smoke.py`` phase 18b) on two
  ranks at ``tiny_split_config``.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from rise_sdf_tpu_torch import bridge, measure, presets
from rise_sdf_tpu_torch.parallel import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = "geometry.encoding.encoding.table"


def test_dryrun_multichip_four_ranks_is_two_by_two(capsys):
    res = dryrun.dryrun_multichip(4, "cpu", "gloo")
    assert (res["data"], res["model"]) == (2, 2)
    assert "data=2 x model=2" in capsys.readouterr().out
    assert np.isfinite(res["loss"])
    ranks = res["ranks"]
    for r in ranks:
        assert tuple(r["params"][TABLE].shape) == (4, 2048, 2)
    for m in range(2):
        a, b = ranks[m], ranks[2 + m]
        # a shard's gradient: its data group's mean, bit for bit at two
        assert torch.equal(a["post"][TABLE],
                           (a["pre"][TABLE] + b["pre"][TABLE]) / 2)
        assert torch.equal(a["params"][TABLE], b["params"][TABLE])
    for k, post in ranks[0]["post"].items():
        if k == TABLE:
            continue
        mean = sum(r["pre"][k].double() for r in ranks) / 4
        torch.testing.assert_close(post.double(), mean, rtol=1e-6,
                                   atol=1e-9, msg=k)
        for r in ranks[1:]:
            assert torch.equal(r["post"][k], post), k
            assert torch.equal(r["params"][k], ranks[0]["params"][k]), k


def test_torchrun_cli_two_table_shards(tmp_path):
    exp = tmp_path / "exp"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "rise_sdf_tpu_torch.launch",
         "--preset", "tiny_neus_config", "--device", "cpu", "--train",
         "--exp_dir", str(exp), "system.table_shards=2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh over 2 ranks: data=1 x model=2" in res.stdout
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
    flat = bridge.load_npz(str(trial / "ckpt" / "step_25.ckpt.npz"))
    for k in ("params/geometry/encoding/table",
              bridge.MU + "geometry/encoding/table",
              bridge.NU + "geometry/encoding/table"):
        assert flat[k].shape == (4, 4096, 2), k
        assert np.abs(flat[k][:, 2048:]).max() > 0, k


def test_measure_ddp_window_with_table_shards(tmp_path):
    """``measure --preset ddp --table-shards 2``'s window on two CPU ranks
    at ``tiny_split_config`` (data=1 x model=2): the shards' rows and the
    replicated params bit-equal where they should be, the model group's
    feature all-reduces counted, the sharded view finite."""
    cfg = presets.tiny_split_config()
    ranks = measure.ddp_window(2, "gloo", str(tmp_path), 16, cfg=cfg,
                               device="cpu", table_shards=2)
    for r in ranks:
        assert r["mesh"][:2] == [1, 2] and r["rays_per_rank"] == 64
        assert r["steps"] == 16 and r["skipped"] == 0
        assert np.all(np.isfinite(r["losses"]))
        assert r["grad_check"]["over_bound"] == 0  # a data group of one
        assert r["params_equal"]
        assert r["allreduce_mb_model"] > 0 and r["allreduce_mb_data"] == 0
        assert r["allreduce_mb_world"] < r["allreduce_mb"]
        assert np.isfinite(r["val"]["psnr"])
    assert ranks[0]["losses"] == ranks[1]["losses"]


def test_table_shard_window_on_two_cpu_ranks(tmp_path):
    """``chip_smoke.py`` phase 18b's window (``measure.
    table_shard_window``) on two CPU ranks at ``tiny_split_config``: the
    reports, each rank's first-step gradients and state, rank 0's view
    and export, and a checkpoint that loads whole in one process."""
    cfg = presets.tiny_split_config()
    ranks = measure.table_shard_window(2, "gloo", str(tmp_path), steps=4,
                                       cfg=cfg, device="cpu")
    for r in ranks:
        assert r["mesh"] == [1, 2, 0, r["rank"]] and r["steps"] == 4
        assert r["skipped"] == 0 and np.all(np.isfinite(r["losses"]))
        assert r["params_equal"] and r["allreduce_mb_model"] > 0
    assert ranks[0]["vertices"] > 0 and ranks[1]["vertices"] is None
    shards = [dict(np.load(tmp_path / f"state{r}.npz")) for r in range(2)]
    grads = [torch.load(tmp_path / f"grads{r}.pt") for r in range(2)]
    assert tuple(grads[0][TABLE].shape) == (4, 2048, 2)
    saved = bridge.load_npz(ranks[0]["ckpt"])
    for k, v in bridge.gather_params(shards).items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)
    view = np.load(tmp_path / "view.npz")
    assert np.isfinite(view["comp_rgb_full"]).all()
