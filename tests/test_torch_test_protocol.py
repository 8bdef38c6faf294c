"""Port parity: the flagship's test protocol (``SplitOccSystem.test``,
``calibrate_eval``, ``predict``, the ``Saver``) on the tiny split config
with the protocol (``tiny_split_test_config``: 2 views at 32x32, the
``warm`` and ``bright`` relight environments, ``derive_compaction``),
on the CPU.

The parameters are the JAX package's init (seed 0) in both packages, at
step 20 (stage 1) with variance 0.3 and a solid occupancy grid (cells
within 1.0 of the centre), where both calibrated fractions land inside
(1/16, 1), so that their check bites.  Tolerances: the calibrated
fractions are equal; the metrics of the multi-emitter and the
single-light mode agree to 1e-3, the bound of the JAX package's own
``test_protocol_metrics_match_single_light_path``; each metric equals
the JAX criterions recomputed on the port's rendered images to 1e-6
(float32 sums in other orders); renders that the same helpers compute
are equal."""

import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.presets import tiny_split_config as jtiny
from rise_sdf_tpu.systems import criterions as jcrit
from rise_sdf_tpu.systems.split_occ import SplitOccSystem as JSplitOcc
from rise_sdf_tpu.utils.color import linear_to_srgb_np as jsrgb
from rise_sdf_tpu_torch import bridge, datasets, presets, systems
from rise_sdf_tpu_torch.ops import scatter as port_scatter
from rise_sdf_tpu_torch.utils.exr import read_exr
from rise_sdf_tpu_torch.utils.gif import quantize, read_gif
from rise_sdf_tpu_torch.utils.saving import JET, Saver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP, VARIANCE, OCC_RADIUS = 20, 0.3, 1.0
METRICS = ("psnr", "phys_psnr", "phys_ssim", "albedo_psnr", "albedo_ssim",
           "roughness_psnr", "normal_mae")


def _solid(res, radius=OCC_RADIUS):
    g = (np.arange(res) + 0.5) / res * 3.0 - 1.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) < radius).reshape(-1)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX system on the protocol config, its init (seed 0) at step
    20 with the solid grid, and its test split."""
    tmp = tmp_path_factory.mktemp("jax")
    cfg = jtiny()
    cfg["model"]["variance"]["init_val"] = VARIANCE
    cfg["model"]["derive_compaction"] = True
    cfg["dataset"].update(
        presets.tiny_split_test_config(str(tmp / "envs"))["dataset"])
    dm = jdatasets.make(cfg.dataset.name, cfg.dataset)
    system = jsystems.make(cfg.system.name, cfg, dm,
                           save_dir=str(tmp / "save"))
    state = system.init_state(0)
    state["step"] = jnp.asarray(STEP, jnp.int32)
    state["occ_binary"] = jnp.asarray(_solid(system.model.grid_resolution))
    return system, state, dm.test()


def _port(tmp, jax_side, multi=True, relights=("warm", "bright"), **model):
    """The port's system on the protocol config with the JAX params."""
    cfg = presets.tiny_split_test_config(str(tmp / "envs"))
    cfg["dataset"]["relight_list"] = list(relights)
    cfg["model"]["variance"]["init_val"] = VARIANCE
    cfg["model"].update(model)
    cfg["system"]["multi_emitter_eval"] = multi
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    system = systems.make(cfg["system"]["name"], cfg, dm,
                          save_dir=str(tmp / f"save_{multi}"), device="cpu")
    system.model.load_state_dict(bridge.from_jax_params(
        bridge.flatten_params(jax_side[1]["params"])), strict=True)
    res = system.model.grid_resolution
    state = {"step": STEP, "occs": torch.zeros(res ** 3),
             "occ_binary": torch.from_numpy(_solid(res))}
    return system, state


def _capture(system):
    """Record every image ``render_image`` returns."""
    images, render = [], system.render_image

    def recording(*args, **kw):
        out = render(*args, **kw)
        images.append(out)
        return out

    system.render_image = recording
    return images


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_side):
    """``test`` in both modes on the same params, with every rendered
    image recorded."""
    out = {}
    for multi in (True, False):
        system, state = _port(tmp_path_factory.mktemp(f"multi{multi}"),
                              jax_side, multi=multi)
        images = _capture(system)
        res = system.test(state, export=False)
        out[multi] = (system, res, images)
    return out


def test_calibrate_eval_matches_jax(tmp_path, jax_side):
    jsys, jstate, jsplit = jax_side
    want = jsys.calibrate_eval(jstate, jsplit)
    system, state = _port(tmp_path, jax_side)
    got = system.calibrate_eval(state, system.datamodule.test())
    assert got == want
    assert all(1 / 16 < v < 1.0 for v in got.values()), got


def test_protocol_modes_agree(runs):
    """One geometry pass for all lights gives the metrics of one render
    per light; each relight image is the single-light render's."""
    (sm, res_m, img_m), (ss, res_s, img_s) = runs[True], runs[False]
    assert sm.eval_fractions == ss.eval_fractions != {}
    assert set(res_m) == set(res_s)
    for k in res_s:
        assert abs(res_m[k] - res_s[k]) < 1e-3, (k, res_m[k], res_s[k])
    assert res_m["dropped_rays"] == res_s["dropped_rays"] == 0
    lights = sm.relight_list
    assert len(img_m) == 2 and len(img_s) == 2 * (1 + len(lights))
    for i, out in enumerate(img_m):
        single = img_s[i * (1 + len(lights)):(i + 1) * (1 + len(lights))]
        for k in ("comp_rgb_full", "comp_rgb_phys_full", "comp_albedo",
                  "depth"):
            np.testing.assert_array_equal(out[k], single[0][k], err_msg=k)
        for j in range(len(lights)):
            np.testing.assert_array_equal(
                out[f"relight{j}/comp_rgb_phys_full"],
                single[1 + j]["comp_rgb_phys_full"])


def test_protocol_metrics_match_jax_criterions(runs):
    """Every metric of the multi-emitter run against the JAX package's
    criterions and median alignment on the port's own images."""
    system, res, images = runs[True]
    split = system.datamodule.test()
    h, w = split.h, split.w
    want = {k: [] for k in METRICS}
    lights = system.relight_list
    for light in lights:
        want[f"relight_psnr_{light}"], want[f"relight_ssim_{light}"] = [], []
    for i, out in enumerate(images):
        mask = split.all_fg_masks[i].reshape(-1, 1)
        white = jsrgb(np.ones(3))[None] * (1 - mask)
        gt = split.all_images[i].reshape(-1, 3) * mask + white
        phys = out["comp_rgb_phys_full"]
        want["psnr"].append(jcrit.psnr(jnp.asarray(out["comp_rgb_full"]),
                                       jnp.asarray(gt)))
        want["phys_psnr"].append(jcrit.psnr(jnp.asarray(phys),
                                            jnp.asarray(gt)))
        want["phys_ssim"].append(jcrit.ssim(
            jnp.asarray(phys.reshape(h, w, 3)),
            jnp.asarray(gt.reshape(h, w, 3))))
        gt_alb = split.all_albedo[i].reshape(-1, 3)
        alb = JSplitOcc._median_align(out["comp_albedo"], gt_alb, mask)
        want["albedo_psnr"].append(jcrit.psnr(jnp.asarray(alb),
                                              jnp.asarray(gt_alb)))
        want["albedo_ssim"].append(jcrit.ssim(
            jnp.asarray(alb.reshape(h, w, 3)),
            jnp.asarray(gt_alb.reshape(h, w, 3))))
        gt_r = split.all_roughness[i].reshape(-1, 1)
        r = JSplitOcc._median_align(out["comp_roughness"], gt_r, mask)
        want["roughness_psnr"].append(jcrit.psnr(jnp.asarray(r),
                                                 jnp.asarray(gt_r)))
        want["normal_mae"].append(jcrit.mean_angular_error(
            jnp.asarray(out["comp_normal"]),
            jnp.asarray(split.all_normals[i].reshape(-1, 3)),
            mask=jnp.asarray(mask), degrees=True))
        for j, light in enumerate(lights):
            gt_rel = split.relight_images[light][i].reshape(-1, 3) * mask \
                + white
            pred = JSplitOcc._median_align(
                out[f"relight{j}/comp_rgb_phys_full"], gt_rel, mask)
            want[f"relight_psnr_{light}"].append(
                jcrit.psnr(jnp.asarray(pred), jnp.asarray(gt_rel)))
            want[f"relight_ssim_{light}"].append(jcrit.ssim(
                jnp.asarray(pred.reshape(h, w, 3)),
                jnp.asarray(gt_rel.reshape(h, w, 3))))
    assert set(res) == set(want) | {"dropped_rays"}
    for k, v in want.items():
        np.testing.assert_allclose(res[k], np.mean([float(x) for x in v]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_protocol_with_one_light_reports_every_metric(tmp_path, jax_side,
                                                      monkeypatch):
    """Every key JAX's ``test`` returns without LPIPS, each finite; the
    grids and the envmap are written; no table gradient (no K1) on the
    way, nor in ``export=True``, which also writes the mesh and the
    material arrays."""
    calls = []
    monkeypatch.setattr(port_scatter, "scatter_add",
                        lambda *a, **k: calls.append(a))
    system, state = _port(tmp_path, jax_side, relights=("warm",))
    res = system.test(state, export=False)
    assert set(res) == set(METRICS) | {"relight_psnr_warm",
                                       "relight_ssim_warm", "dropped_rays"}
    assert all(np.isfinite(v) for v in res.values()), res
    assert calls == []
    assert all(p.grad is None for p in system.model.parameters())
    save = system.save_dir
    assert os.path.exists(os.path.join(save, f"it{STEP}-envmap.exr"))
    for i in range(2):
        for suffix in ("", "-pbr", "-albedo", "-relight-warm"):
            assert os.path.exists(os.path.join(
                save, f"it{STEP}-test", f"{i}{suffix}.png")), (i, suffix)
    # the views' grids and their PBR grids as GIFs, JAX's names
    for name, suffix in ((f"it{STEP}-test", ""), (f"it{STEP}-test-pbr",
                                                   "-pbr")):
        frames, _ = read_gif(os.path.join(save, f"{name}.gif"))
        assert len(frames) == 2, name
        for i, frame in enumerate(frames):
            png = _read_png(os.path.join(save, f"it{STEP}-test",
                                         f"{i}{suffix}.png"))
            idx, pal = quantize(png)
            np.testing.assert_array_equal(frame, pal[idx])
    system.test(state)
    assert calls == []
    iso = system.config["model"]["geometry"]["isosurface"]
    assert os.path.exists(os.path.join(
        save, f"it{STEP}-{iso['method']}{iso['resolution']}.ply"))
    for k in ("albedo", "metallic", "roughness"):
        assert os.path.exists(os.path.join(save, f"{k}.npy"))


def test_forced_escalation_in_multi_mode_gives_single_light_images(
        tmp_path, jax_side):
    """A buffer of 16 samples per ray overflows at the base size and fits
    at 2x: the multi-emitter chunk re-renders with its lights and gives
    the single-light images, every ray included."""
    system, state = _port(tmp_path, jax_side, eval_samples_per_ray=16,
                          eval_visibility_frac=1.0)
    mults, render_chunk = [], system.render_chunk

    def spy(state_, rays, mult=1, **kw):
        mults.append(mult)
        return render_chunk(state_, rays, mult, **kw)

    system.render_chunk = spy
    split = system.datamodule.test()
    base = system.model.emitter.relight_params(
        os.path.join(system.config["dataset"]["hdr_filepath"],
                     "warm.exr"))["base"]
    multi = system.render_image(state, split, 0, emitter_base=[None, base],
                                n_relights=1)
    assert 2 in mults and 4 not in mults, mults
    nvs = system.render_image(state, split, 0)
    rel = system.render_image(state, split, 0, emitter_base=base,
                              relighting=True)
    assert multi["ray_included"].all()
    for k in ("comp_rgb_full", "comp_rgb_phys_full", "opacity"):
        np.testing.assert_array_equal(multi[k], nvs[k], err_msg=k)
    np.testing.assert_array_equal(multi["relight0/comp_rgb_phys_full"],
                                  rel["comp_rgb_phys_full"])


def test_predict_renders_every_test_view(tmp_path, jax_side):
    system, state = _port(tmp_path, jax_side, relights=("bright",))
    split = system.datamodule.test()
    system.predict(state, os.path.join(
        system.config["dataset"]["hdr_filepath"], "bright.exr"))
    for i in range(len(split)):
        img = _read_png(os.path.join(system.save_dir,
                                     f"it{STEP}-predict-bright", f"{i}.png"))
        assert img.shape == (split.h, split.w, 3) and img.max() > 0
    frames, _ = read_gif(os.path.join(system.save_dir,
                                      f"it{STEP}-predict-bright.gif"))
    assert len(frames) == len(split)


def _read_png(path):
    """Decode an 8-bit RGB PNG whose rows are unfiltered, checking every
    chunk's CRC."""
    with open(path, "rb") as f:
        buf = f.read()
    assert buf[:8] == b"\x89PNG\r\n\x1a\n"
    off, chunks = 8, {}
    while off < len(buf):
        (n,) = struct.unpack(">I", buf[off:off + 4])
        kind, data = buf[off + 4:off + 8], buf[off + 8:off + 8 + n]
        (crc,) = struct.unpack(">I", buf[off + 8 + n:off + 12 + n])
        assert crc == zlib.crc32(kind + data) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + data
        off += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_saver_png_and_exr_grids_read_back(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.uniform(-0.2, 1.2, (7, 5, 3)).astype(np.float32)
    normal = rng.uniform(-1, 1, (7, 5, 3)).astype(np.float32)
    gray = rng.uniform(0, 2, (7, 5)).astype(np.float32)
    short = rng.uniform(0, 1, (4, 3, 3)).astype(np.float32)
    saver = Saver(str(tmp_path))
    path = saver.save_image_grid("grid/a.png", [
        {"type": "rgb", "img": rgb},
        {"type": "rgb", "img": normal, "kwargs": {"data_range": (-1, 1)}},
        {"type": "grayscale", "img": gray,
         "kwargs": {"data_range": None, "cmap": None}},
        {"type": "grayscale", "img": gray},
        {"type": "rgb", "img": short}])
    u8 = (np.clip(gray, 0, 1) * 255).astype(np.uint8)
    auto = ((gray - gray.min()) / (gray.max() - gray.min()) * 255).astype(
        np.uint8)
    want = np.concatenate([
        (np.clip(rgb, 0, 1) * 255).astype(np.uint8),
        (np.clip((normal + 1) / 2, 0, 1) * 255).astype(np.uint8),
        np.stack([u8] * 3, -1), JET[auto],
        np.pad((short * 255).astype(np.uint8), ((0, 3), (0, 0), (0, 0)))],
        axis=1)
    np.testing.assert_array_equal(_read_png(path), want)
    # jet runs from dark blue through green to dark red
    np.testing.assert_array_equal(JET[[0, 255]], [[0, 0, 128], [128, 0, 0]])
    assert JET[128, 1] == 255 and (JET[:, 1].argmax() in range(96, 160))
    exr_path = saver.save_image_grid("grid/b.exr", [
        {"type": "hdr", "img": rgb * 4}, {"type": "hdr", "img": gray}])
    np.testing.assert_array_equal(read_exr(exr_path), np.concatenate(
        [rgb * 4, np.repeat(gray[..., None], 3, -1)], axis=1))
    saver.save_npy("arr/c.npy", rgb)
    np.testing.assert_array_equal(np.load(tmp_path / "arr" / "c.npy"), rgb)


def test_port_imports_no_jax_cv2_pil_imageio_or_reference():
    """Every module of the port, the test protocol's included, imports
    none of jax, yaml, cv2, PIL, imageio or the JAX package."""
    code = (
        "import pkgutil, sys, importlib, rise_sdf_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'yaml', 'cv2', 'PIL', 'imageio',\n"
        "              'rise_sdf_tpu'))\n"
        "assert not bad, bad\n"
        "need = [p.__name__ + '.' + m for m in ('utils.exr',\n"
        "        'utils.saving', 'systems.split_occ', 'systems.criterions',\n"
        "        'models.light', 'datasets.synthetic', 'measure')]\n"
        "assert all(m in sys.modules for m in need), need\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
