"""Port parity: the split-sum PBR stack against the JAX package on the
CPU — bf16 MLP heads, the frequency encoding, cubemap sampling and mip
atlases, the FG table, the diffuse and specular prefilters, the
mip-cubemap light and the five-head texture.

Tolerances: float32 paths agree to 1e-5 (the two frameworks sum in
other orders); the FG table and the filter bank are the same numpy
code, so equal.  The bf16 MLP is held to 2e-3 of the output's largest
entry, and its median entry to 1e-6: both sides round inputs and
weights to bf16 and keep the products in float32
(``preferred_element_type``), so they differ only where a hidden value
that the two sums left 1 float32 ulp apart rounds to neighbouring bf16
values.  Rounding each layer's output to bf16, as a torch bf16 matmul
does, misses both bounds (about 5e-3 of the largest entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu import nn as jnn
from rise_sdf_tpu.models.light import EnvLightMipCube as JLight
from rise_sdf_tpu.models.texture import VolumeMixedMipSplitOcc as JTexture
from rise_sdf_tpu.ops import cubemap as jcube
from rise_sdf_tpu.ops import fg_lut as jfg
from rise_sdf_tpu.ops import prefilter as jpre
from rise_sdf_tpu.presets import tiny_split_config as jtiny_split
from rise_sdf_tpu_torch import bridge
from rise_sdf_tpu_torch import nn as tnn
from rise_sdf_tpu_torch.models.light import EnvLightMipCube
from rise_sdf_tpu_torch.models.texture import VolumeMixedMipSplitOcc
from rise_sdf_tpu_torch.ops import cubemap, fg_lut, prefilter
from rise_sdf_tpu_torch.presets import tiny_split_config

TOL = dict(rtol=1e-5, atol=1e-5)
LIGHT = {"envlight_config": {"hdr_filepath": None, "clamp": True,
                             "nmf_format": False, "scale": 0.5, "bias": 0.25,
                             "base_res": 32}}


def _dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3))
    d[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
             [0, 0, -1]]
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _cube(res, seed, c=3):
    return np.random.default_rng(seed).uniform(
        0, 1, (6, res, res, c)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------- #
# nn: bf16 MLP, frequency encoding
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("sphere", [False, True], ids=["relu", "sphere_wn"])
def test_bf16_mlp_matches_jax(sphere):
    cfg = {"otype": "VanillaMLP", "activation": "ReLU",
           "output_activation": "none", "n_neurons": 64,
           "n_hidden_layers": 3, "compute_dtype": "bfloat16"}
    if sphere:
        cfg.update({"sphere_init": True, "sphere_init_radius": 0.5,
                    "weight_norm": True})
    jm = jnn.MLP(40, 7, cfg)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda v: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32),
        jm.init(jax.random.PRNGKey(1)))
    tm = tnn.MLP(40, 7, cfg)
    tm.load_state_dict(bridge.from_jax_params(bridge.flatten_params(params)),
                       strict=True)
    x = rng.standard_normal((256, 40)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3 * scale)
    assert np.median(np.abs(got.numpy() - want)) <= 1e-6 * scale
    # and it is a bf16 product: the float32 path differs by more than
    # float32 rounding
    tm.compute_dtype = torch.float32
    assert np.abs(tm(torch.from_numpy(x)).detach().numpy() - want).max() \
        > 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("masking", [0, 40], ids=["plain", "masked"])
def test_frequency_encoding_matches_jax(masking):
    cfg = {"otype": "VanillaFrequency", "n_frequencies": 6,
           "n_masking_step": masking}
    je, te = jnn.get_encoding(3, cfg), tnn.get_encoding(3, cfg)
    assert te.n_output_dims == je.n_output_dims == 36
    x = np.random.default_rng(2).uniform(-1, 1, (128, 3)).astype(np.float32)
    for step in (None, 0, 17, 100):
        want = np.asarray(je.apply({}, jnp.asarray(x), step))
        got = te(torch.from_numpy(x), step).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------------------- #
# cubemaps
# --------------------------------------------------------------------- #


def test_face_uv_directions_and_solid_angle_match_jax():
    d = _dirs(500, 0)
    for g, w in zip(cubemap.dir_to_face_uv(torch.from_numpy(d)),
                    jcube.dir_to_face_uv(jnp.asarray(d))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(cubemap.face_directions(8).numpy(),
                               np.asarray(jcube.face_directions(8)), **TOL)
    np.testing.assert_allclose(cubemap.texel_solid_angle(8).numpy(),
                               np.asarray(jcube.texel_solid_angle(8)), **TOL)


def test_sample_cubemap_and_pool_match_jax():
    cube, d = _cube(16, 1), _dirs(400, 2)
    np.testing.assert_allclose(
        cubemap.sample_cubemap(_t(cube), _t(d)).numpy(),
        np.asarray(jcube.sample_cubemap(jnp.asarray(cube), jnp.asarray(d))),
        **TOL)
    np.testing.assert_allclose(
        cubemap.avg_pool_cubemap(_t(cube)).numpy(),
        np.asarray(jcube.avg_pool_cubemap(jnp.asarray(cube))), **TOL)


def test_sample_cubemap_mips_atlas_matches_jax():
    mips = [_cube(32 >> i, 3 + i) for i in range(3)]
    d = _dirs(400, 6)
    level = np.random.default_rng(7).uniform(-0.5, 2.5, 400).astype(
        np.float32)
    want = jcube.sample_cubemap_mips_atlas([jnp.asarray(m) for m in mips],
                                           jnp.asarray(d), jnp.asarray(level))
    got = cubemap.sample_cubemap_mips_atlas([_t(m) for m in mips], _t(d),
                                            _t(level))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sample_texture2d_matches_jax():
    tex = np.random.default_rng(8).uniform(0, 1, (16, 24, 2)).astype(
        np.float32)
    uv = np.random.default_rng(9).uniform(-0.1, 1.1, (300, 2)).astype(
        np.float32)
    np.testing.assert_allclose(
        cubemap.sample_texture2d(_t(tex), _t(uv)).numpy(),
        np.asarray(jcube.sample_texture2d(jnp.asarray(tex), jnp.asarray(uv))),
        **TOL)


# --------------------------------------------------------------------- #
# FG table and prefilters
# --------------------------------------------------------------------- #


def test_fg_lut_equals_jax(tmp_path):
    want = jfg.fg_lut(16, cache_dir=str(tmp_path))
    nov = np.linspace(0, 1, 33)
    rough = np.linspace(0, 1, 33)[::-1]
    np.testing.assert_array_equal(fg_lut.integrate_fg(nov, rough),
                                  jfg.integrate_fg(nov, rough))
    got = fg_lut.fg_lut(16)
    assert got.shape == (16, 16, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_specular_filter_bank_equals_jax():
    got = prefilter.build_specular_filter_bank(32)
    want = jpre.build_specular_filter_bank(32)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.target_res, g.work_res) == (w.target_res, w.work_res)
        for k in ("dense", "idx", "w"):
            a, b = getattr(g, k), getattr(w, k)
            assert (a is None) == (b is None), k
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(prefilter.diffuse_filter_matrix(16),
                                  jpre.diffuse_filter_matrix(16))


def test_diffuse_and_specular_filters_match_jax():
    cube = _cube(16, 10)
    np.testing.assert_allclose(
        prefilter.apply_diffuse_filter(_t(cube)).numpy(),
        np.asarray(jpre.apply_diffuse_filter(jnp.asarray(cube))), **TOL)
    chain = [_cube(32, 11)]
    chain.append(np.asarray(jcube.avg_pool_cubemap(jnp.asarray(chain[0]))))
    for filt in prefilter.build_specular_filter_bank(32):
        want = jpre.apply_specular_level_filter(
            filt, [jnp.asarray(c) for c in chain])
        got = prefilter.apply_specular_level_filter(
            prefilter.to_torch(filt, "cpu"), [_t(c) for c in chain])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------- #
# light and texture
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def light_pair():
    jl, tl = JLight(LIGHT), EnvLightMipCube(LIGHT)
    params = {"base": jnp.asarray(_cube(32, 12))}
    tl.load_state_dict({"base": _t(params["base"])})
    return jl, tl, params


def test_light_reset_parameters_range():
    tl = EnvLightMipCube(LIGHT)
    tl.reset_parameters(torch.Generator().manual_seed(0))
    b = tl.base.detach()
    assert b.shape == (6, 32, 32, 3)
    assert float(b.min()) >= 0.25 and float(b.max()) <= 0.75
    assert tl.n_levels == JLight(LIGHT).n_levels == 2


def test_build_mips_matches_jax(light_pair):
    jl, tl, params = light_pair
    want = jl.build_mips(params)
    got = tl.build_mips()
    np.testing.assert_allclose(got.diffuse.detach().numpy(),
                               np.asarray(want.diffuse), **TOL)
    assert len(got.specular) == len(want.specular)
    for g, w in zip(got.specular, want.specular):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_eval_mip_matches_jax(light_pair):
    jl, tl, params = light_pair
    jm, tm = jl.build_mips(params), tl.build_mips()
    d = _dirs(300, 13)
    rough = np.random.default_rng(14).uniform(0, 1, (300, 1)).astype(
        np.float32)
    for spec in (False, True):
        want = jl.eval_mip(jm, jnp.asarray(d), specular=spec,
                           roughness=jnp.asarray(rough))
        got = tl.eval_mip(tm, _t(d), specular=spec, roughness=_t(rough))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
    np.testing.assert_allclose(tl.get_mip(_t(rough)).numpy(),
                               np.asarray(jl.get_mip(jnp.asarray(rough))),
                               **TOL)


@pytest.mark.parametrize("stage", [0, 1])
def test_texture_apply_matches_jax(light_pair, stage):
    jl, tl, lparams = light_pair
    cfg = tiny_split_config()["model"]["texture"]
    assert cfg == jtiny_split().model.texture
    jt, tt = JTexture(cfg), VolumeMixedMipSplitOcc(cfg)
    rng = np.random.default_rng(15)
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32),
        jt.init(jax.random.PRNGKey(2)))
    tt.load_state_dict(bridge.from_jax_params(
        bridge.flatten_params(params, "params")), strict=True)
    n = 200
    feats = rng.standard_normal((n, 13)).astype(np.float32)
    dirs, normals = _dirs(n, 16), _dirs(n, 17)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    jmips, tmips = jl.build_mips(lparams), tl.build_mips()
    want = jt.apply(params, jnp.asarray(feats), jnp.asarray(dirs),
                    jnp.asarray(normals), jnp.asarray(pos), emitter=jl,
                    mips=jmips, stage=stage, step=20)
    got = tt.apply(_t(feats), _t(dirs), _t(normals), _t(pos), emitter=tl,
                   mips=tmips, stage=stage, step=20)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k, **TOL)
    want = jt.secondary_shading(params, jnp.asarray(feats), jnp.asarray(dirs),
                                jnp.asarray(normals), step=20)
    got = tt.secondary_shading(_t(feats), _t(dirs), _t(normals), step=20)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
