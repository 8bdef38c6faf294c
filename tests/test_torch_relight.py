"""Port parity: the relighting pieces of the flagship's test protocol
against the JAX package on the CPU — EXR files, the lat-long <-> cubemap
conversions and the emitter's HDR paths, the synthetic test split's
material and relight ground truth, the protocol's metrics, the
third-bounce split sum, and the eval ``forward(relighting=True)`` and
``forward_multi`` of the tiny split pair of ``tests/test_torch_split.py``.

Tolerances: EXR bytes, the datasets (both numpy) and the stat counts
are equal; the conversions, the emitter's bases and the metrics agree
to 1e-6 (float32 ops in other orders: SSIM's window sums, ``atan2``);
the texture to 1e-5 as ``tests/test_torch_pbr.py`` holds it; the
forwards to 1e-4 (``comp_rgb_full``, ``opacity``, ``comp_rgb_phys_full``
and each relight image), chunk by chunk, as
``test_eval_forward_matches_jax`` holds the eval forward.

The JAX forwards run under ``jax.jit`` here (op by op the relighting
forward compiles for about 70 s on one core).  ``test_torch_split.py``
runs them op by op because jit fuses the secondary march's ``near + i *
step`` into one rounding that drops a sample exactly on the far plane;
with the pair's solid occupancy grid no secondary sample near the far
plane is live, which the equal ``stat_secondary_live`` counts show."""

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu.datasets import synthetic as jsyn
from rise_sdf_tpu.models.light import EnvLightMipCube as JLight
from rise_sdf_tpu.models.texture import VolumeMixedMipSplitOcc as JTexture
from rise_sdf_tpu.ops import cubemap as jcube
from rise_sdf_tpu.systems import criterions as jcrit
from rise_sdf_tpu.utils import exr as jexr
from rise_sdf_tpu_torch import bridge
from rise_sdf_tpu_torch.datasets import synthetic as tsyn
from rise_sdf_tpu_torch.models.light import EnvLightMipCube, load_hdr_image
from rise_sdf_tpu_torch.models.texture import VolumeMixedMipSplitOcc
from rise_sdf_tpu_torch.ops import cubemap
from rise_sdf_tpu_torch.presets import tiny_split_config
from rise_sdf_tpu_torch.systems import criterions
from rise_sdf_tpu_torch.utils import exr
from test_torch_split import CHUNK, _split_pair

TOL6 = dict(rtol=0, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _light(**kw):
    ec = {"hdr_filepath": None, "clamp": False, "nmf_format": False,
          "scale": 0.5, "bias": 0.25, "base_res": 32}
    ec.update(kw)
    return {"envlight_config": ec}


def _latlong(h=24, seed=0):
    """A smooth HDR lat-long image with values above 1."""
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid((np.arange(h) + 0.5) / h,
                         (np.arange(2 * h) + 0.5) / (2 * h), indexing="ij")
    img = np.stack([1.0 + np.sin(2 * np.pi * gx),
                    0.5 + 0.5 * np.cos(np.pi * gy),
                    2.5 * gx * gy], -1)
    return (img + 0.05 * rng.random(img.shape)).astype(np.float32)


# --------------------------------------------------------------------- #
# EXR files
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(9, 11), (17, 23, 3), (6, 5, 4)],
                         ids=["1ch", "rgb", "rgba"])
def test_exr_files_match_jax_both_ways(tmp_path, shape):
    """The port writes JAX's bytes; each side reads the other's file back
    bit-equal."""
    img = np.random.default_rng(1).uniform(0, 10, shape).astype(np.float32)
    pj, pt = str(tmp_path / "jax.exr"), str(tmp_path / "port.exr")
    jexr.write_exr(pj, img)
    exr.write_exr(pt, img)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    want = img if img.ndim == 3 else img[..., None]
    for got in (exr.read_exr(pj), jexr.read_exr(pt)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _compressed_exr(path, img, compression):
    """A ZIPS (2, one line per block) or ZIP (3, 16 lines per block)
    float32 EXR written with the predictor; the last ZIP block is short
    and one block is stored raw (compression would not shrink it)."""
    h, w, _ = img.shape
    names = ["B", "G", "R"]  # alphabetical storage order
    src = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}

    def attr(name, typ, val):
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<i", len(val)) + val)

    chans = b"".join(nm.encode() + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
                     for nm in names) + b"\x00"
    header = attr("channels", "chlist", chans)
    header += attr("compression", "compression", bytes([compression]))
    header += attr("dataWindow", "box2i",
                   struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += b"\x00"
    pre = struct.pack("<ii", 20000630, 2) + header
    per = 1 if compression == 2 else 16
    blocks = []
    for y in range(0, h, per):
        raw = b"".join(src[nm][yy].tobytes() for yy in range(y, min(y + per,
                                                                    h))
                       for nm in names)
        comp = zlib.compress(exr._predictor_encode(raw))
        if len(comp) >= len(raw) or y == per:
            comp = raw
        blocks.append(struct.pack("<ii", y, len(comp)) + comp)
    offsets, pos = [], len(pre) + 8 * len(blocks)
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(pre + struct.pack(f"<{len(blocks)}Q", *offsets)
                + b"".join(blocks))


@pytest.mark.parametrize("compression", [2, 3], ids=["zips", "zip"])
def test_exr_reads_zip_compressed_like_jax(tmp_path, compression):
    rng = np.random.default_rng(compression)
    img = np.round(rng.uniform(0, 4, (37, 13, 3)), 1).astype(np.float32)
    p = str(tmp_path / "c.exr")
    _compressed_exr(p, img, compression)
    got = exr.read_exr(p)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jexr.read_exr(p))
    data = rng.integers(0, 256, 1001).astype(np.uint8).tobytes()
    assert exr._predictor_encode(data) == jexr._predictor_encode(data)
    assert exr._predictor_decode(exr._predictor_encode(data)) == data


# --------------------------------------------------------------------- #
# lat-long <-> cubemap, the emitter's files
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("fn", ["blender_latlong_to_cubemap",
                                "nmf_latlong_to_cubemap",
                                "cubemap_to_blender_latlong",
                                "cubemap_to_latlong"])
def test_latlong_conversions_match_jax(fn):
    """On smooth maps: a float32 ``atan2`` or ``sin`` one ulp apart moves
    a lookup by ~1e-6 of a texel, times the jump to the next texel."""
    if fn.endswith("to_cubemap"):
        arg, extra = _latlong(), 16
    else:  # the warm sky on the cube's texel directions
        d = cubemap.face_directions(16).numpy().astype(np.float64)
        arg, extra = jsyn.env_radiance_warm(d), (20, 40)
    want = np.asarray(getattr(jcube, fn)(jnp.asarray(arg), extra))
    got = getattr(cubemap, fn)(_t(arg), extra).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL6)


@pytest.mark.parametrize("clamp,nmf", [(True, False), (False, True)],
                         ids=["blender_clamped", "nmf"])
def test_emitter_hdr_paths_match_jax(tmp_path, clamp, nmf):
    """The HDR-file init (``clamp``, ``nmf_format``), ``relight_params``
    (never clamped), the mips of a relight base and the lat-long dump."""
    path = str(tmp_path / "env.exr")
    exr.write_exr(path, _latlong(32, 3))
    cfg = _light(hdr_filepath=path, clamp=clamp, nmf_format=nmf)
    jl, tl = JLight(cfg), EnvLightMipCube(cfg)
    jparams = jl.init(jax.random.PRNGKey(0))
    np.testing.assert_allclose(tl.base.detach().numpy(),
                               np.asarray(jparams["base"]), **TOL6)
    assert (float(tl.base.detach().max()) <= 1.0) == clamp
    tl.reset_parameters(torch.Generator().manual_seed(1))  # file again
    np.testing.assert_allclose(tl.base.detach().numpy(),
                               np.asarray(jparams["base"]), **TOL6)
    want = jl.relight_params(path)["base"]
    got = tl.relight_params(path)["base"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL6)
    assert float(got.max()) > 1.0
    jm, tm = jl.build_mips({"base": want}), tl.build_mips(got)
    np.testing.assert_allclose(tm.diffuse.numpy(), np.asarray(jm.diffuse),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(tm.specular, jm.specular):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(tl.generate_image().numpy(),
                               np.asarray(jl.generate_image(jparams)),
                               **TOL6)


def test_radiance_hdr_files_raise(tmp_path):
    """A ``.hdr`` file that is not Radiance RGBE raises, as does an
    environment map of another format (``.hdr`` files are read since the
    RGBE reader, ``tests/test_torch_readers.py``)."""
    path = tmp_path / "env.hdr"
    path.write_bytes(b"P6\n2 2\n255\n" + bytes(12))
    with pytest.raises(ValueError, match="Radiance"):
        load_hdr_image(str(path))
    with pytest.raises(ValueError, match=r"\.exr or \.hdr"):
        load_hdr_image(str(tmp_path / "env.png"))


# --------------------------------------------------------------------- #
# the synthetic test split
# --------------------------------------------------------------------- #


def test_synthetic_test_split_matches_jax(tmp_path):
    """Images, masks, albedo, roughness and normals of every split, the
    relight ground truth of the test split and its EXRs: equal."""
    def cfg(env_dir):
        return {"img_wh": [24, 20], "n_images": 2,
                "relight_list": ["warm", "bright"],
                "hdr_filepath": str(tmp_path / env_dir), "pose_phase": 0.5}

    for name in ("test", "val"):
        want = jsyn.SyntheticSplit(cfg("jax"), name)
        got = tsyn.SyntheticSplit(cfg("port"), name)
        for k in ("all_c2w", "all_images", "all_fg_masks", "all_albedo",
                  "all_roughness", "all_normals"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=k)
        assert sorted(got.relight_images) == sorted(want.relight_images)
        assert bool(got.relight_images) == (name == "test")
        for light, img in want.relight_images.items():
            np.testing.assert_array_equal(got.relight_images[light], img)
            assert np.abs(img - want.all_images).max() > 0.05
            with open(tmp_path / "jax" / f"{light}.exr", "rb") as a, \
                    open(tmp_path / "port" / f"{light}.exr", "rb") as b:
                assert a.read() == b.read()
    np.testing.assert_array_equal(
        tsyn.camera_poses(4, seed=2, phase=0.5),
        jsyn.camera_poses(4, seed=2, phase=0.5))


# --------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------- #


def test_criterions_match_jax():
    rng = np.random.default_rng(4)
    a = rng.random((30, 41, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    b[:8, :8] = 0.5  # a flat window: the variance clamps
    np.testing.assert_allclose(
        float(criterions.ssim(_t(a), _t(b))),
        float(jcrit.ssim(jnp.asarray(a), jnp.asarray(b))), **TOL6)
    pa, pb = a.reshape(-1, 3), b.reshape(-1, 3)
    for mask in (None, rng.random((pa.shape[0], 1)) < 0.4,
                 rng.random(pa.shape) < 0.4):
        m = (None, None) if mask is None else (_t(mask), jnp.asarray(mask))
        np.testing.assert_allclose(
            float(criterions.psnr(_t(pa), _t(pb), m[0])),
            float(jcrit.psnr(jnp.asarray(pa), jnp.asarray(pb), m[1])),
            rtol=1e-6)
    n0, n1 = rng.standard_normal((2, 500, 3)).astype(np.float32)
    n1[:50] = -n0[:50]  # opposite normals: 180 degrees, not capped
    fg = (rng.random((500, 1)) < 0.6).astype(np.float32)
    for mask, deg in ((None, False), (fg, True)):
        m = (None, None) if mask is None else (_t(mask), jnp.asarray(mask))
        np.testing.assert_allclose(
            float(criterions.mean_angular_error(_t(n0), _t(n1), m[0], deg)),
            float(jcrit.mean_angular_error(jnp.asarray(n0), jnp.asarray(n1),
                                           m[1], deg)), rtol=1e-6)


# --------------------------------------------------------------------- #
# the third bounce's split sum
# --------------------------------------------------------------------- #


def test_secondary_shading_pbr_matches_jax():
    """The third-bounce hit's material cache and its split sum under one
    light, the specular light looked up along the incoming direction."""
    cfg = tiny_split_config()["model"]["texture"]
    jt, tt = JTexture(cfg), VolumeMixedMipSplitOcc(cfg)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32),
        jt.init(jax.random.PRNGKey(2)))
    tt.load_state_dict(bridge.from_jax_params(bridge.flatten_params(params)),
                       strict=True)
    base = rng.uniform(0, 2, (6, 32, 32, 3)).astype(np.float32)
    jl, tl = JLight(_light()), EnvLightMipCube(_light())
    jmips, tmips = jl.build_mips({"base": jnp.asarray(base)}), \
        tl.build_mips(_t(base))
    n = 300
    feats = rng.standard_normal((n, 13)).astype(np.float32)
    dirs, normals = (v / np.linalg.norm(v, axis=-1, keepdims=True) for v in
                     rng.standard_normal((2, n, 3)).astype(np.float32))
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    want = jax.jit(lambda *a: jt.secondary_shading_pbr(
        params, *a, jl, jmips, step=20))(
        jnp.asarray(feats), jnp.asarray(dirs), jnp.asarray(normals),
        jnp.asarray(pos))
    with torch.no_grad():
        got = tt.secondary_shading_pbr(_t(feats), _t(dirs), _t(normals),
                                       _t(pos), tl, tmips, step=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------- #
# forward(relighting=True) and forward_multi
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def relight_pair():
    """``_split_pair`` (the tiny split config with the bench's eval
    options, float32) plus a second light: the learned base brightened
    and channel-rolled, as ``tests/test_multi_emitter.py`` makes it."""
    p = _split_pair("float32")
    base2 = jnp.roll(p["params"]["emitter"]["base"] * 1.7 + 0.05, 1, -1)
    p["jmips1"] = p["jm"].emitter.build_mips({"base": base2})
    p["tmips1"] = p["tm"].emitter.build_mips(_t(base2))
    return p


@pytest.mark.parametrize("frac", [1.0, 0.5], ids=["full", "compacted"])
def test_relight_forwards_match_jax(relight_pair, frac):
    """``forward_multi`` with the learned light and a relight light, and
    ``forward(relighting=True)``, against JAX's, chunk by chunk, without
    and with both compactions (``vis_frac`` and ``secondary_frac``)."""
    p = relight_pair
    jm, tm, params = p["jm"], p["tm"], p["params"]
    kw = dict(stage=1, capacity=p["capacity"], prefilter=True, banded=True,
              vis_frac=frac, secondary_frac=frac)
    step = jnp.asarray(p["step"], jnp.int32)

    @jax.jit
    def jax_multi(rays, occ):
        return jm.forward_multi(params, rays, occ_binary=occ,
                                mips_list=[p["jmips"], p["jmips1"]],
                                step=step, relight_flags=(False, True),
                                background_color=jnp.ones((3,)), **kw)

    @jax.jit
    def jax_relight(rays, occ):
        return jm.forward(params, rays, occ_binary=occ, mips=p["jmips1"],
                          step=step, rng=None, train=False, relighting=True,
                          background_color=jnp.ones((3,)), **kw)

    keys = ("comp_rgb_full", "opacity", "comp_rgb_phys_full")
    got = {k: [] for k in ("nvs", "relight", "single")}
    want = {k: [] for k in got}
    third = 0
    for s in range(0, p["rays"].shape[0], CHUNK):
        rays = p["rays"][s:s + CHUNK]
        occ = jnp.asarray(p["occ"].numpy())
        w_multi = jax_multi(jnp.asarray(rays.numpy()), occ)
        w_single = jax_relight(jnp.asarray(rays.numpy()), occ)
        g_multi = tm.forward_multi(
            rays, occ_binary=p["occ"], mips_list=[p["tmips"], p["tmips1"]],
            step=p["step"], relight_flags=(False, True),
            background_color=torch.ones(3), bake=p["tbake"], **kw)
        g_single = tm(rays, occ_binary=p["occ"], mips=p["tmips1"],
                      step=p["step"], relighting=True,
                      background_color=torch.ones(3), bake=p["tbake"], **kw)
        for g, w in ((g_multi[0], w_multi[0]), (g_single, w_single)):
            for k in ("stat_live", "stat_vis", "stat_secondary_live",
                      "num_samples"):
                np.testing.assert_array_equal(
                    g[k].numpy(), np.asarray(w[k]),
                    err_msg=f"{k}, chunk at {s}")
        assert int(g_multi[0]["stat_vis"]) > 0
        for name, g, w in (("nvs", g_multi[0], w_multi[0]),
                           ("relight", g_multi[1], w_multi[1]),
                           ("single", g_single, w_single)):
            np.testing.assert_array_equal(g["ray_included"].numpy(),
                                          np.asarray(w["ray_included"]))
            got[name].append({k: g[k].numpy() for k in keys})
            want[name].append({k: np.asarray(w[k]) for k in keys})
        # glossy foreground pixels, where the third bounce is blended
        third += int(((g_single["comp_roughness"] <= 0.3)
                      & (g_single["opacity"] > 0.5)).sum())
    for name in got:
        for k in keys:
            np.testing.assert_allclose(
                np.concatenate([c[k] for c in got[name]]),
                np.concatenate([c[k] for c in want[name]]), rtol=0,
                atol=1e-4, err_msg=f"{name}: {k}")
    assert third > 0
    # the relight light differs, and the two relight renders agree
    nvs = np.concatenate([c["comp_rgb_phys_full"] for c in got["nvs"]])
    rel = np.concatenate([c["comp_rgb_phys_full"] for c in got["relight"]])
    single = np.concatenate([c["comp_rgb_phys_full"] for c in got["single"]])
    assert np.abs(nvs - rel).max() > 1e-2
    np.testing.assert_array_equal(rel, single)
