"""The port's CLI, ``python -m rise_sdf_tpu_torch.launch``, end to end on
the CPU in subprocesses (counterpart of ``tests/test_launch.py``):
``--train`` leaves the parsed config, a checkpoint, the test PNGs and
the mesh; ``--test --resume`` renders from that checkpoint without
training; a dotlist override lands in ``parsed.json``; an unknown key
and a run without CUDA and without ``--device cpu`` exit non-zero;
``--preset neus_colmap`` raises without ``dataset.root_dir`` and with it
trains on a capture in COLMAP's layout (shrunk by overrides) in a run
named after the capture's directory.  Also the dotlist's value
parser.  ``--config configs/split-smoke.yaml`` trains across the stage
flip and tests, leaving ``parsed.yaml`` (the JAX package's
``load_config`` of the same dotlist) and ``raw.yaml`` (the file);
``--config`` and ``--preset`` exclude each other, and a yaml's ``???``
left unset raises before anything is written."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from rise_sdf_tpu.config import config_to_primitive, load_config
from rise_sdf_tpu_torch import launch
from rise_sdf_tpu_torch.launch import apply_overrides, parse_value
from test_torch_colmap import write_capture
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


# neus_colmap's widths and depth cut for a CPU run of a few seconds
COLMAP_TINY = [
    "trainer.max_steps=4", "dataset.img_downscale=2",
    "model.num_samples_per_ray=64", "model.train_num_rays=64",
    "model.max_train_num_rays=64", "model.train_sample_capacity=4096",
    "model.eval_samples_per_ray=32", "model.ray_chunk=128",
    "model.num_samples_per_ray_bg=16",
    "model.geometry.xyz_encoding_config.log2_hashmap_size=12",
    "model.geometry_bg.xyz_encoding_config.log2_hashmap_size=12",
    "model.geometry.isosurface.resolution=32"]


def test_neus_colmap_needs_root_dir_and_names_the_run(tmp_path):
    exp = str(tmp_path / "exp_dir")
    res = _launch("--preset", "neus_colmap", "--train", "--device", "cpu",
                  "--exp_dir", exp)
    assert res.returncode != 0
    assert "missing mandatory config value: dataset.root_dir" in res.stderr
    assert not os.path.exists(exp)
    capture = str(tmp_path / "garden")
    write_capture(capture)
    res = _launch("--preset", "neus_colmap", "--train", "--device", "cpu",
                  "--exp_dir", exp, f"dataset.root_dir={capture}/",
                  *COLMAP_TINY)
    assert res.returncode == 0, res.stderr[-3000:]
    trials = glob.glob(os.path.join(exp, "neus-colmap-garden", "@*"))
    assert len(trials) == 1
    save = os.path.join(trials[0], "save")
    assert sorted(os.listdir(os.path.join(save, "it4-test"))) == [
        "0.png", "1.png"]
    assert os.path.exists(os.path.join(trials[0], "ckpt", "step_4.ckpt.npz"))
    with open(os.path.join(trials[0], "config", "parsed.json")) as f:
        cfg = json.load(f)
    assert cfg["name"] == "neus-colmap-garden"
    assert cfg["model"]["learned_background"] is True


SMOKE = os.path.join(ROOT, "configs", "split-smoke.yaml")


def test_config_trains_split_smoke_across_the_flip(tmp_path, capsys):
    """11 steps (the stage flips at 10), then the test protocol, in this
    process; YAML 1.1 typing in the dotlist (``1.0e-2`` a float)."""
    exp = str(tmp_path / "exp")
    cli = ["trainer.max_steps=11", "system.optimizer.args.lr=1.0e-2"]
    launch.main(["--config", SMOKE, "--train", "--device", "cpu",
                 "--exp_dir", exp, *cli])
    out = capsys.readouterr().out
    (trial,) = glob.glob(os.path.join(exp, "split-smoke", "smoke@*"))
    assert sorted(os.listdir(os.path.join(trial, "config"))) == [
        "parsed.yaml", "raw.yaml"]
    with open(os.path.join(trial, "config", "raw.yaml")) as f, \
            open(SMOKE) as g:
        assert f.read() == g.read()
    with open(os.path.join(trial, "config", "parsed.yaml")) as f:
        parsed = yaml.safe_load(f)
    assert parsed.pop("cmd_args")["config"] == SMOKE
    assert parsed.pop("trial_dir") == trial
    assert parsed == config_to_primitive(load_config(SMOKE, cli_args=cli))
    assert isinstance(parsed["system"]["optimizer"]["args"]["lr"], float)
    assert os.path.exists(os.path.join(trial, "ckpt", "step_11.ckpt.npz"))
    save = os.path.join(trial, "save")
    assert {f"{i}{part}.png" for i in range(3) for part in (
        "", "-albedo", "-pbr")} <= set(os.listdir(os.path.join(
            save, "it11-test")))
    assert "phys_psnr" in out  # stage 1's metrics


@pytest.mark.parametrize("args,message", [
    (["--config", SMOKE, "--preset", "tiny_neus_config"], "not allowed"),
    ([], "one of the arguments --config --preset is required")])
def test_config_and_preset_exclude_each_other(args, message):
    res = subprocess.run(
        [sys.executable, "-m", "rise_sdf_tpu_torch.launch", "--train",
         "--device", "cpu", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0 and message in res.stderr


def test_config_needs_the_yamls_mandatory_values(tmp_path):
    with pytest.raises(ValueError, match="dataset.scene"):
        launch.main(["--config", os.path.join(ROOT, "configs",
                                               "neus-blender.yaml"),
                     "--train", "--device", "cpu", "--exp_dir",
                     str(tmp_path)])
    assert not any(tmp_path.iterdir())
