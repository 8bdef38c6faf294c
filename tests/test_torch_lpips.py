"""The port's LPIPS (``rise_sdf_tpu_torch/systems/lpips.py``) against the
JAX package's (``rise_sdf_tpu/systems/lpips.py``), with
``tests/test_lpips.py``'s synthetic VGG16 weights (no real weights can
be downloaded here).

Without weights the metric is off on both sides, with one note.  With
them the port's LPIPS is within 1e-5 (relative) of JAX's at 64x64 and
at a shape that is not square.  The tiny split config's ``test`` gives
the ``*_lpips`` keys JAX's ``test`` gives, each equal (1e-5) to JAX's
``lpips`` on the port's own images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.presets import tiny_split_config as jtiny
from rise_sdf_tpu.systems import lpips as JL
from rise_sdf_tpu.systems.split_occ import SplitOccSystem as JSplitOcc
from rise_sdf_tpu.utils.color import linear_to_srgb_np as jsrgb
from rise_sdf_tpu_torch import bridge, datasets, presets, systems
from rise_sdf_tpu_torch.systems import lpips as TL

from test_lpips import _write_random_weights

RTOL = 1e-5
STEP, VARIANCE = 20, 0.3


@pytest.fixture()
def weights(tmp_path, monkeypatch):
    path = str(tmp_path / "vgg16_lpips.npz")
    _write_random_weights(path)
    monkeypatch.setenv("RISE_SDF_LPIPS_WEIGHTS", path)
    JL.reset_cache()
    TL.reset_cache()
    yield path
    JL.reset_cache()
    TL.reset_cache()


def test_unavailable_without_weights(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("RISE_SDF_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    TL.reset_cache()
    try:
        assert not TL.available() and not TL.available()
        assert TL.lpips(np.zeros((8, 8, 3)), np.ones((8, 8, 3)),
                        device="cpu") is None
        assert capsys.readouterr().out.count("LPIPS disabled") == 1
    finally:
        TL.reset_cache()


@pytest.mark.parametrize("shape,seed", [((64, 64), 1), ((64, 64), 2),
                                        ((48, 80), 3)])
def test_matches_jax(weights, shape, seed):
    assert TL.available() and JL.available()
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape, 3), 0, 1).astype(np.float32)
    got, want = TL.lpips(a, b, device="cpu"), JL.lpips(a, b)
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert TL.lpips(a, a, device="cpu") == 0.0
    np.testing.assert_allclose(TL.lpips(b, a, device="cpu"), got, rtol=RTOL)


def _solid(res, radius=1.0):
    g = (np.arange(res) + 0.5) / res * 3.0 - 1.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) < radius).reshape(-1)


def test_split_test_lpips_keys_match_jax(weights, tmp_path):
    """JAX's and the port's ``test`` on the same params (JAX's init at
    step 20, as ``tests/test_torch_test_protocol.py``), the weights set."""
    env = str(tmp_path / "envs")
    cfg = jtiny()
    cfg["model"]["variance"]["init_val"] = VARIANCE
    cfg["model"]["derive_compaction"] = True
    cfg["dataset"].update(presets.tiny_split_test_config(env)["dataset"])
    jsys = jsystems.make(cfg.system.name, cfg,
                         jdatasets.make(cfg.dataset.name, cfg.dataset),
                         save_dir=str(tmp_path / "jax"))
    jstate = jsys.init_state(0)
    jstate["step"] = jnp.asarray(STEP, jnp.int32)
    jstate["occ_binary"] = jnp.asarray(_solid(jsys.model.grid_resolution))
    want = jsys.test(jstate, export=False)

    tcfg = presets.tiny_split_test_config(env)
    tcfg["model"]["variance"]["init_val"] = VARIANCE
    tsys = systems.make(tcfg["system"]["name"], tcfg,
                        datasets.make(tcfg["dataset"]["name"],
                                      tcfg["dataset"]),
                        save_dir=str(tmp_path / "port"), device="cpu")
    tsys.model.load_state_dict(bridge.from_jax_params(
        bridge.flatten_params(jstate["params"])), strict=True)
    res = tsys.model.grid_resolution
    state = {"step": STEP, "occs": torch.zeros(res ** 3),
             "occ_binary": torch.from_numpy(_solid(res))}
    images, render = [], tsys.render_image

    def recording(*args, **kw):
        out = render(*args, **kw)
        images.append(out)
        return out

    tsys.render_image = recording
    got = tsys.test(state, export=False)
    keys = {k for k in want if "lpips" in k}
    assert keys == {"phys_lpips", "albedo_lpips", "relight_lpips_warm",
                    "relight_lpips_bright"}
    assert {k for k in got if "lpips" in k} == keys
    assert set(got) == set(want) | {"dropped_rays"}

    # each value: JAX's lpips on the port's images, the JAX package's
    # median alignment, averaged over the views
    split = tsys.datamodule.test()
    h, w = split.h, split.w
    ref = {k: [] for k in keys}
    for i, out in enumerate(images):
        mask = split.all_fg_masks[i].reshape(-1, 1)
        white = jsrgb(np.ones(3))[None] * (1 - mask)
        gt = split.all_images[i].reshape(-1, 3) * mask + white
        ref["phys_lpips"].append(JL.lpips(
            out["comp_rgb_phys_full"].reshape(h, w, 3), gt.reshape(h, w, 3)))
        gt_alb = split.all_albedo[i].reshape(-1, 3)
        alb = JSplitOcc._median_align(out["comp_albedo"], gt_alb, mask)
        ref["albedo_lpips"].append(JL.lpips(alb.reshape(h, w, 3),
                                            gt_alb.reshape(h, w, 3)))
        for j, light in enumerate(tsys.relight_list):
            gt_rel = split.relight_images[light][i].reshape(-1, 3) * mask \
                + white
            pred = JSplitOcc._median_align(
                out[f"relight{j}/comp_rgb_phys_full"], gt_rel, mask)
            ref[f"relight_lpips_{light}"].append(JL.lpips(
                pred.reshape(h, w, 3), gt_rel.reshape(h, w, 3)))
    for k in keys:
        assert np.isfinite(got[k]) and got[k] > 0, k
        np.testing.assert_allclose(got[k], np.mean(ref[k]), rtol=RTOL,
                                   err_msg=k)
