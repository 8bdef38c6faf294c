"""The port's CLI, ``python -m rise_sdf_tpu_torch.launch``, end to end on
the CPU in subprocesses (counterpart of ``tests/test_launch.py``):
``--train`` leaves the parsed config, a checkpoint, the test PNGs and
the mesh; ``--test --resume`` renders from that checkpoint without
training; a dotlist override lands in ``parsed.json``; an unknown key
and a run without CUDA and without ``--device cpu`` exit non-zero.
Also the dotlist's value parser."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rise_sdf_tpu_torch.launch import apply_overrides, parse_value
from rise_sdf_tpu_torch.utils.saving import load_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "rise_sdf_tpu_torch.launch",
         "--preset", "tiny_neus_config", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    exp = str(tmp_path_factory.mktemp("launch"))
    res = _launch("--train", "--device", "cpu", "--exp_dir", exp,
                  "trainer.max_steps=12", "trainer.save_every_n_steps=8",
                  "model.background_color=white")
    assert res.returncode == 0, res.stderr[-3000:]
    trials = glob.glob(os.path.join(exp, "exp", "@*"))
    assert len(trials) == 1
    return exp, trials[0]


def test_train_writes_config_checkpoint_images_and_mesh(trained):
    _, trial = trained
    assert sorted(os.listdir(trial)) == ["ckpt", "config", "save"]
    ckpts = sorted(os.listdir(os.path.join(trial, "ckpt")))
    assert ckpts == ["latest.ckpt.npz", "step_12.ckpt.npz"]
    save = os.path.join(trial, "save")
    assert sorted(os.listdir(os.path.join(save, "it12-test"))) == [
        "0.png", "1.png", "2.png"]
    verts, faces = load_ply(os.path.join(save, "it12-mc32.ply"))
    assert len(faces) > 100 and np.isfinite(verts).all()


def test_override_lands_in_parsed_json(trained):
    _, trial = trained
    with open(os.path.join(trial, "config", "parsed.json")) as f:
        cfg = json.load(f)
    assert cfg["trainer"]["max_steps"] == 12
    assert cfg["trainer"]["save_every_n_steps"] == 8
    assert cfg["model"]["background_color"] == "white"
    assert cfg["cmd_args"]["train"] is True
    assert cfg["trial_dir"].endswith(os.path.basename(trial))


def test_test_resumes_without_training(trained):
    exp, trial = trained
    ckpt = os.path.join(trial, "ckpt", "step_12.ckpt.npz")
    res = _launch("--test", "--device", "cpu", "--exp_dir", exp,
                  "--resume", ckpt)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "step 0:" not in res.stdout and "test/psnr" in res.stdout
    new = [t for t in glob.glob(os.path.join(exp, "exp", "@*"))
           if t != trial]
    assert len(new) == 1
    assert os.listdir(os.path.join(new[0], "ckpt")) == []
    save = os.path.join(new[0], "save")
    assert os.path.exists(os.path.join(save, "it12-test", "0.png"))
    assert os.path.exists(os.path.join(save, "it12-mc32.ply"))


@pytest.mark.parametrize("args,env,message", [
    (["--device", "cpu", "trainer.no_such_key=1"], None,
     "unknown config key 'trainer.no_such_key'"),
    ([], {"CUDA_VISIBLE_DEVICES": ""}, "CUDA is not available"),
])
def test_bad_runs_exit_nonzero(tmp_path, args, env, message):
    res = _launch("--train", "--exp_dir", str(tmp_path), *args, env=env)
    assert res.returncode != 0
    assert message in res.stderr


def test_parse_value_and_overrides():
    assert parse_value("3") == 3 and isinstance(parse_value("3"), int)
    assert parse_value("1e-3") == 1e-3
    assert parse_value("True") is True and parse_value("false") is False
    assert parse_value("null") is None
    assert parse_value("[1, 2.5, true]") == [1, 2.5, True]
    assert parse_value("lego") == "lego"
    cfg = {"a": {"b": 1}, "trainer": {}}
    apply_overrides(cfg, ["a.b=[0.5]", "seed=9",
                          "trainer.save_every_n_steps=4"])
    assert cfg == {"a": {"b": [0.5]}, "seed": 9,
                   "trainer": {"save_every_n_steps": 4}}
    with pytest.raises(KeyError, match="a.c"):
        apply_overrides(cfg, ["a.c=1"])
    with pytest.raises(KeyError, match="x.b"):
        apply_overrides(cfg, ["x.b=1"])
    with pytest.raises(ValueError):
        apply_overrides(cfg, ["a.b"])
