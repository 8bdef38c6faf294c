"""Port parity: the flagship's test protocol on a TensoIR-layout scene
read from disk, relighting under Radiance ``.hdr`` environments, against
the JAX package's ``SplitOccSystem.test`` on the CPU.

The scene: the concave scene (``render_image_concave``) at 32x32, 2
train and 2 test views in the TensoIR layout (``rgba.png`` and the
relight PNGs by PIL, the material and normal EXRs by the EXR writer),
with ``warm.hdr`` and ``bright.hdr`` written by cv2 and no ``.exr``
environment beside them.  The config is ``tiny_split_test_config`` with
its dataset switched to ``tensoir``; the parameters are the JAX
package's init (seed 0) at step 20 (stage 1) with variance 0.3 and a
solid occupancy grid, as ``tests/test_torch_test_protocol.py`` sets them
up.  Tolerances, those of that file: the calibrated fractions are equal,
and every metric (the relight PSNR and SSIM of both lights among them)
is within 1e-3 of JAX's.
"""

import json
import math

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.presets import tiny_split_config as jtiny
from rise_sdf_tpu_torch import bridge, datasets, presets, systems
from rise_sdf_tpu_torch.datasets import synthetic as syn
from rise_sdf_tpu_torch.models import light as port_light
from rise_sdf_tpu_torch.utils.exr import write_exr
from rise_sdf_tpu_torch.utils.rays import get_ray_directions

STEP, VARIANCE, OCC_RADIUS, SIZE, FOV = 20, 0.3, 1.0, 32, 0.42
LIGHTS = ["warm", "bright"]


def _solid(res, radius=OCC_RADIUS):
    g = (np.arange(res) + 0.5) / res * 3.0 - 1.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) < radius).reshape(-1)


def _u8(x):
    return np.round(np.clip(x, 0, 1) * 255).astype(np.uint8)


def write_scene(root):
    """The concave scene in the TensoIR layout under ``root``, and its
    relight environments as ``.hdr`` files in ``root / "envs"``."""
    focal = 0.5 * SIZE / math.tan(0.5 * FOV)
    dirs = get_ray_directions(SIZE, SIZE, focal, focal, SIZE // 2,
                              SIZE // 2)
    envs = root / "envs"
    envs.mkdir()
    for light in LIGHTS:
        # RGBE holds no negative radiance (the warm sky's lower half)
        img = np.maximum(syn.env_latlong(syn._ENVS[light], 16), 0)
        assert cv2.imwrite(str(envs / f"{light}.hdr"), img[..., ::-1])
    for split, seed in (("train", 0), ("test", 2)):
        for i, c2w in enumerate(syn.camera_poses(2, seed=seed)):
            d = root / f"{split}_{i:03d}"
            d.mkdir()
            mat = np.concatenate([c2w, [[0, 0, 0, 1]]]).reshape(-1)
            (d / "metadata.json").write_text(json.dumps({
                "cam_transform_mat": ",".join(repr(float(v)) for v in mat),
                "cam_angle_x": FOV, "w": SIZE, "h": SIZE}))
            rgb, mask, alb, rough, nrm = syn.render_image_concave(
                c2w, dirs, env_fn=syn.env_radiance_bright)
            Image.fromarray(_u8(np.concatenate([rgb, mask[..., None]], -1)),
                            "RGBA").save(d / "rgba.png")
            write_exr(str(d / "albedo.exr"), alb)
            write_exr(str(d / "roughness.exr"), rough)
            write_exr(str(d / "normal.exr"),
                      np.concatenate([nrm, mask[..., None]], -1))
            for light in LIGHTS:
                rel = syn.render_image_concave(c2w, dirs,
                                               env_fn=syn._ENVS[light])[0]
                Image.fromarray(_u8(np.concatenate(
                    [rel, mask[..., None]], -1)), "RGBA").save(
                        d / f"rgba_{light}.png")
    return envs


def _dataset(root, envs):
    cfg = presets.tiny_split_test_config(str(envs))["dataset"]
    cfg.update({"name": "tensoir", "root_dir": str(root),
                "img_wh": [SIZE, SIZE], "relight_list": LIGHTS,
                "albedo_format": "exr", "roughness_format": "exr"})
    del cfg["n_images"]
    return cfg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("tensoir")
    return root, write_scene(root)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, scene):
    """JAX's ``test`` on the scene: its params, fractions and metrics."""
    cfg = jtiny()
    cfg["model"]["variance"]["init_val"] = VARIANCE
    cfg["model"]["derive_compaction"] = True
    cfg["dataset"] = _dataset(*scene)
    dm = jdatasets.make(cfg.dataset.name, cfg.dataset)
    system = jsystems.make(cfg.system.name, cfg, dm, save_dir=str(
        tmp_path_factory.mktemp("jax_save")))
    state = system.init_state(0)
    state["step"] = jnp.asarray(STEP, jnp.int32)
    state["occ_binary"] = jnp.asarray(_solid(system.model.grid_resolution))
    fractions = system.calibrate_eval(state, dm.test())
    res = system.test(state, export=False)
    return state["params"], fractions, res


def _port(tmp, scene, params):
    cfg = presets.tiny_split_test_config(str(scene[1]))
    cfg["dataset"] = _dataset(*scene)
    cfg["model"]["variance"]["init_val"] = VARIANCE
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    system = systems.make(cfg["system"]["name"], cfg, dm,
                          save_dir=str(tmp / "save"), device="cpu")
    system.model.load_state_dict(bridge.from_jax_params(
        bridge.flatten_params(params)), strict=True)
    res = system.model.grid_resolution
    state = {"step": STEP, "occs": torch.zeros(res ** 3),
             "occ_binary": torch.from_numpy(_solid(res))}
    return system, state


def test_scene_holds_hdr_environments_only(scene):
    _, envs = scene
    assert sorted(p.name for p in envs.iterdir()) == ["bright.hdr",
                                                      "warm.hdr"]


def test_hdr_relight_protocol_matches_jax(tmp_path, scene, jax_run,
                                          monkeypatch):
    params, want_fr, want = jax_run
    read = []
    load = port_light.load_hdr_image

    def spy(path):
        read.append(path)
        return load(path)

    monkeypatch.setattr(port_light, "load_hdr_image", spy)
    system, state = _port(tmp_path, scene, params)
    got = system.test(state, export=False)
    assert sorted(read) == sorted(str(scene[1] / f"{l}.hdr")
                                  for l in LIGHTS)
    assert system.eval_fractions == want_fr
    assert got["dropped_rays"] == 0
    for light in LIGHTS:
        for m in ("psnr", "ssim"):
            assert f"relight_{m}_{light}" in got
    keys = set(got) - {"dropped_rays"}
    assert keys <= set(want), keys - set(want)
    for k in sorted(keys):
        assert np.isfinite(got[k]), k
        assert abs(got[k] - float(want[k])) < 1e-3, (k, got[k], want[k])
