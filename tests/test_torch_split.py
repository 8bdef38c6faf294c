"""Port parity: the flagship eval render (split-mixed-occ) against the JAX
package on the CPU — the visibility cut and band, exact-K band marching,
the dense secondary march, the baked SDF table, the flagship parameter
tree, and the whole eval ``forward`` of the tiny split config with the
prefilter, bands, both compactions and the full bake.

Tolerances: per-op float32 paths agree to 1e-5 (the two frameworks sum
in other orders) and index / count outputs are equal.  The whole
``forward`` is held to 1e-4 on ``comp_rgb_full`` and ``opacity``, to
1e-4 of its value (plus 1e-4) on ``depth``, and to equality on
``ray_included`` and the ``stat_*`` counts.  These bounds hold for
chunks of 16 rays, not for one chunk of all 64: the transmittance scan
is the JAX package's design, one float32 cumsum over the whole sample
buffer with each ray's start subtracted, so both sides carry an error of
about |running sum| x 2^-24 in each ray's log-transmittance.  At the
bench's inv_s ~ 812 a saturated sample adds log(1.2e-7) ~ -16 to the
sum; with 64 rays in one buffer it reaches -2,950 and the two sides'
weights differ by 2.4e-4 (each is ~2e-4 from a float64 scan), with 16
rays by at most 6e-5.  ``depth`` sums those weights times t ~ 3.5.
With every MLP in bf16 the forward is held to the same bounds, and the
baked table to 1e-5 in 99 % of its entries.  The JAX forward runs op
by op, as the JAX package's own model tests run it: under ``jax.jit``
XLA fuses ``near + i * step`` of the secondary march into one rounding, which puts the last secondary sample
exactly on the far plane and drops it, while op-by-op JAX and the port
keep it (1.4999999 < 1.5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu.ops import march as jmarch
from rise_sdf_tpu.ops import sdf_bake as jbake
from rise_sdf_tpu.ops import volrend as jvolrend
from rise_sdf_tpu_torch import bench, bridge, models, presets
from rise_sdf_tpu_torch.ops import march, sdf_bake, volrend

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK = 16  # rays per eval forward in the whole-forward parity test
R = 1.5
AABB = (np.full(3, -R, np.float32), np.full(3, R, np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _aabb(lib):
    return (_t(AABB[0]), _t(AABB[1])) if lib is torch \
        else (_j(AABB[0]), _j(AABB[1]))


def _sphere_view_rays(n, seed):
    """Rays from a sphere of radius 4 towards points near the origin."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.8, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _probe_buffer(seed, n_rays=40, capacity=600):
    """A compacted probe buffer: ray-major samples with increasing t,
    dead tail slots, rays without samples and a few opaque samples."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 25, n_rays)
    counts[::7] = 0
    ray_idx = np.repeat(np.arange(n_rays), counts)
    ray_end = np.cumsum(counts)
    ray_start = np.minimum(ray_end - counts, capacity)
    live = min(len(ray_idx), capacity)
    ray_indices = np.full(capacity, n_rays)
    ray_indices[:live] = ray_idx[:live]
    valid = np.arange(capacity) < live
    alphas = rng.uniform(0.0, 0.3, capacity).astype(np.float32)
    alphas[::11] = 0.995
    t_starts = np.zeros(capacity, np.float32)
    for r in range(n_rays):
        sl = slice(ray_end[r] - counts[r], min(ray_end[r], capacity))
        t_starts[sl] = 2.5 + 0.05 * np.arange(sl.stop - sl.start)
    return alphas, t_starts, ray_start, ray_indices, valid, n_rays


# --------------------------------------------------------------------- #
# volrend: visibility, cut, band, dense weights
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("fn", ["transmittance_cut", "transmittance_band",
                                "render_visibility"])
def test_visibility_reductions_match_jax(fn):
    a, ts, start, ridx, valid, n = _probe_buffer(1)
    args_j = (_j(a), _j(ts), _j(start.astype(np.int32)),
              _j(ridx.astype(np.int32)), _j(valid), n)
    args_t = (_t(a), _t(ts), _t(start), _t(ridx), _t(valid), n)
    if fn == "render_visibility":
        want = jvolrend.render_visibility(*args_j[:1], *args_j[2:],
                                          alpha_thre=0.01)
        got = volrend.render_visibility(*args_t[:1], *args_t[2:],
                                        alpha_thre=0.01)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < int(valid.sum())
        return
    want = getattr(jvolrend, fn)(*args_j, margin=0.02)
    got = getattr(volrend, fn)(*args_t, margin=0.02)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        # cut and band ends are t values picked from the buffer: exact
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cut = got[-1].numpy()
    assert (cut < 1e10).any() and (cut >= 1e10).any()
    if fn == "transmittance_band":
        lo = got[0].numpy()
        # rays that never enter get -1e10 (the JAX package's sentinel)
        assert (lo <= -1e10).any() and (lo > -1e10).any()


def test_render_weight_from_alpha_dense_matches_jax():
    rng = np.random.default_rng(2)
    alphas = rng.uniform(0.0, 1.0, (24, 16)).astype(np.float32)
    live = rng.random((24, 16)) < 0.7
    want = jvolrend.render_weight_from_alpha_dense(_j(alphas), _j(live))
    got = volrend.render_weight_from_alpha_dense(_t(alphas), _t(live))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# --------------------------------------------------------------------- #
# march: exact-K bands, the coarse probe, the dense secondary march
# --------------------------------------------------------------------- #


def _band(n, seed):
    """Per-ray bands: finite, empty (hi <= lo) and unbounded rays."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(2.6, 3.8, n).astype(np.float32)
    hi = (lo + rng.uniform(0.02, 0.6, n)).astype(np.float32)
    lo[::5] = -np.inf
    hi[::6] = 1e10
    hi[3::9] = lo[3::9] - 0.1
    return lo, hi


@pytest.mark.parametrize("band_k,capacity", [(None, 4096), (8, 4096),
                                             (8, 300)],
                         ids=["masked", "exact_k", "exact_k_overflow"])
def test_banded_march_matches_jax(band_k, capacity):
    o, d = _sphere_view_rays(48, 3)
    lo, hi = _band(48, 4)
    binary = np.random.default_rng(5).random(16 ** 3) < 0.7
    kw = dict(step_size=1.732 * 2 * R / 128, num_samples=128,
              capacity=capacity, grid_resolution=16, band_k=band_k)
    lo_j, hi_j = _aabb(jnp)
    want = jmarch.march_rays(_j(o), _j(d), aabb_min=lo_j, aabb_max=hi_j,
                             grid_binary=_j(binary), rng=None, t_cut=_j(hi),
                             t_band_lo=_j(lo), **kw)
    lo_t, hi_t = _aabb(torch)
    got = march.march_rays(_t(o), _t(d), aabb_min=lo_t, aabb_max=hi_t,
                           grid_binary=_t(binary), generator=None,
                           t_cut=_t(hi), t_band_lo=_t(lo), **kw)
    for name in ("ray_indices", "valid", "ray_start", "ray_count",
                 "ray_included", "num_live"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("t_starts", "t_ends"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    counts = got.ray_count.numpy()
    if band_k:
        assert (counts == band_k).sum() >= 5
    if capacity == 300:
        assert not got.ray_included.all()


@pytest.mark.parametrize("band", [False, True], ids=["cut", "band"])
def test_compute_visibility_cut_matches_jax(band):
    """The coarse probe on a sphere SDF of radius 0.5 (inv_s 400): the
    neighbour cosines of ``jnp.roll`` at ray boundaries, lone probes,
    and rays that overflow the probe buffer."""
    o, d = _sphere_view_rays(40, 6)
    o[:4] = [[0, 0, -4]] * 4
    d[:4] = [[0, 0, 1], [0, 0.12, 0.99], [0, 0.3, 0.95], [0.2, 0, 0.98]]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    binary = np.random.default_rng(7).random(16 ** 3) < 0.8
    kw = dict(inv_s=400.0, step_size=1.732 * 2 * R / 256, num_samples=256,
              capacity=900, grid_resolution=16, stride=4, band=band,
              cos_anneal_ratio=1.0, margin_intervals=1.0)
    lo_j, hi_j = _aabb(jnp)
    want = jmarch.compute_visibility_cut(
        _j(o), _j(d), sdf_fn=lambda p: jnp.linalg.norm(p, axis=-1) - 0.5,
        aabb_min=lo_j, aabb_max=hi_j, grid_binary=_j(binary), **kw)
    lo_t, hi_t = _aabb(torch)
    got = march.compute_visibility_cut(
        _t(o), _t(d),
        sdf_fn=lambda p: torch.linalg.vector_norm(p, dim=-1) - 0.5,
        aabb_min=lo_t, aabb_max=hi_t, grid_binary=_t(binary), **kw)
    want = want if band else (want,)
    got = got if band else (got,)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        np.testing.assert_array_equal(g >= 1e10, w >= 1e10)
        fin = np.isfinite(g) & (g < 1e10)
        np.testing.assert_allclose(g[fin], w[fin], **TOL)
    cut = got[-1].numpy()
    assert (cut < 1e10).sum() >= 4 and (cut >= 1e10).any()


def test_march_rays_dense_matches_jax():
    o, d = _sphere_view_rays(32, 8)
    o = (0.3 * o / 4.0).astype(np.float32)  # secondary origins in the box
    binary = np.random.default_rng(9).random(16 ** 3) < 0.5
    kw = dict(near_plane=0.05, far_plane=1.5, num_samples=24,
              grid_resolution=16)
    lo_j, hi_j = _aabb(jnp)
    want = jmarch.march_rays_dense(_j(o), _j(d), aabb_min=lo_j,
                                   aabb_max=hi_j, grid_binary=_j(binary),
                                   rng=None, **kw)
    lo_t, hi_t = _aabb(torch)
    got = march.march_rays_dense(_t(o), _t(d), aabb_min=lo_t, aabb_max=hi_t,
                                 grid_binary=_t(binary), generator=None, **kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < int(got[2].sum()) < got[2].numel()


# --------------------------------------------------------------------- #
# the baked SDF table
# --------------------------------------------------------------------- #


def _blob(lib):
    """A smooth non-separable test SDF."""
    def fn(p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return lib.sqrt(x * x + 1.3 * y * y + 0.8 * z * z) - 0.6 \
            + 0.1 * lib.sin(3 * x) * lib.cos(2 * z)
    return fn


def test_bake_and_pack_corners_match_jax():
    lo_j, hi_j = _aabb(jnp)
    want = jbake.bake_packed(_blob(jnp), lo_j, hi_j, cells=12, chunk=500)
    lo_t, hi_t = _aabb(torch)
    got = sdf_bake.bake_packed(_blob(torch), lo_t, hi_t, cells=12, chunk=500)
    assert got["cells"] == int(want["cells"]) == 12
    assert got["packed"].shape == (13 ** 3, 8)
    np.testing.assert_allclose(got["packed"].numpy(),
                               np.asarray(want["packed"]), **TOL)
    # pack_corners moves values: bit-equal on the same vertices
    verts = np.random.default_rng(10).standard_normal((7, 7, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(
        sdf_bake.pack_corners(_t(verts)).numpy(),
        np.asarray(jbake.pack_corners(_j(verts))))


@pytest.mark.parametrize("fn", ["sample_packed", "sample_packed_grad"])
def test_sample_packed_matches_jax(fn):
    lo_j, hi_j = _aabb(jnp)
    jb = jbake.bake_packed(_blob(jnp), lo_j, hi_j, cells=12)
    tb = {"packed": _t(jb["packed"]), "cells": 12}
    pos = np.random.default_rng(11).uniform(-1.7, 1.7, (700, 3)).astype(
        np.float32)
    want = getattr(jbake, fn)(jb, _j(pos), lo_j, hi_j)
    lo_t, hi_t = _aabb(torch)
    got = getattr(sdf_bake, fn)(tb, _t(pos), lo_t, hi_t)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("n,chunk,mode", [
    (640000, 4096, "golden"), (1000, 64, True), (1000, 64, "strided"),
    (1000, 64, "off"), (50, 64, "golden")])
def test_interleave_order_equals_jax(n, chunk, mode):
    """The eval-ray permutation and its inverse: equal index arrays."""
    from rise_sdf_tpu.utils.misc import interleave_order as jorder
    from rise_sdf_tpu_torch.utils.misc import interleave_order

    (order, inv), (jo, ji) = interleave_order(n, chunk, mode), \
        jorder(n, chunk, mode)
    if jo is None:
        assert order is None and inv is None
        return
    np.testing.assert_array_equal(order, jo)
    np.testing.assert_array_equal(inv, ji)
    np.testing.assert_array_equal(order[inv], np.arange(n))


def test_rgb_to_srgb_matches_jax():
    """Linear -> sRGB on both branches of the curve (1e-6)."""
    from rise_sdf_tpu.utils.color import rgb_to_srgb as jsrgb
    from rise_sdf_tpu_torch.utils.color import rgb_to_srgb

    f = np.random.default_rng(12).uniform(-0.1, 1.5, 1000).astype(
        np.float32)
    f[:4] = [0.0, 0.0031308, 0.0031309, 1.0]
    np.testing.assert_allclose(rgb_to_srgb(_t(f)).numpy(),
                               np.asarray(jsrgb(_j(f))), rtol=0, atol=1e-6)


# --------------------------------------------------------------------- #
# the flagship parameter tree
# --------------------------------------------------------------------- #


def test_flagship_preset_and_tree_round_trip(tmp_path):
    """``split_mixed_occ_full`` is the model section of
    ``configs/split-mixed-occ-tensoir.yaml``; the JAX package's flagship
    params load into the port (strict) and come back bit-equal, through
    an ``.npz`` as a checkpoint carries them."""
    from rise_sdf_tpu import models as jmodels
    from rise_sdf_tpu.config import load_config

    cfg = load_config("configs/split-mixed-occ-tensoir.yaml",
                      cli_args=["dataset.scene=bench"])
    ported = presets.split_mixed_occ_full()["model"]
    want = cfg.model.to_dict() if hasattr(cfg.model, "to_dict") \
        else dict(cfg.model)
    assert _plain(want) == ported

    jm = jmodels.make(cfg.model.name, cfg.model)
    params = jm.init(jax.random.PRNGKey(3))
    flat = bridge.flatten_params(params)
    tm = models.make(ported["name"], ported)
    tm.load_state_dict(bridge.from_jax_params(flat), strict=True)
    heads = {k.split(".")[1] for k in tm.state_dict() if k.startswith(
        "texture.")}
    assert heads >= {"albedo", "metallic", "roughness", "secondary",
                     "env"}
    assert tm.geometry.encoding.encoding.table.shape == (16, 2 ** 19, 2)
    assert tm.emitter.base.shape == (6, 512, 512, 3)
    path = bridge.save_npz(str(tmp_path / "flagship.npz"),
                           bridge.to_jax_params(tm.state_dict()))
    back = bridge.load_npz(path)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def _plain(node):
    if hasattr(node, "items"):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


# --------------------------------------------------------------------- #
# the whole eval forward
# --------------------------------------------------------------------- #


def _split_pair(compute_dtype):
    """The tiny split config with the bench's eval options
    (``bench.tiny_bench_config``: prefilter, exact-K bands of 8, both
    compactions, the full bake) and every MLP (geometry and texture
    heads) computing in ``compute_dtype``, the same params on both
    sides, the bench camera at 8x8 and its solid occupancy grid."""
    from rise_sdf_tpu import models as jmodels
    from rise_sdf_tpu.presets import tiny_split_config as jtiny

    tcfg = bench.tiny_bench_config()["model"]
    for sec in (tcfg["geometry"], tcfg["texture"]):
        for k in sec:
            if k.endswith("mlp_network_config"):
                sec[k] = dict(sec[k], compute_dtype=compute_dtype)
    base = presets.tiny_split_config()["model"]
    jcfg = jtiny()
    jcfg.model.merge({k: v for k, v in tcfg.items() if base.get(k) != v})
    jm = jmodels.make(jcfg.model.name, jcfg.model)
    params = jm.init(jax.random.PRNGKey(0))
    tm = models.make(tcfg["name"], tcfg)
    tm.load_state_dict(bridge.from_jax_params(bridge.flatten_params(params)),
                       strict=True)
    tm.requires_grad_(False)
    rays = bench.image_rays(8, "cpu")
    occ = bench.solid_occupancy(tm, "cpu")
    step = jcfg.model.split_sum_kick_in_step + 10
    jbake_ = jm.bake_eval_sdf(params, step)
    tbake = tm.bake_eval_sdf(step)
    got, want = tbake["packed"].numpy(), np.asarray(jbake_["packed"])
    if compute_dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        # bf16: a value the two sums leave 1 float32 ulp apart can round
        # to neighbouring bf16 values, which moves ~0.6 % of the corners
        # by up to ~1e-3; rounding each layer's output to bf16 would
        # move nearly all of them
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
        assert np.mean(np.abs(got - want) > 1e-5) < 0.01
    return dict(jm=jm, params={**params, "_eval_bake": jbake_}, tm=tm,
                rays=rays, occ=occ, step=step, tbake=tbake,
                jmips=jm.emitter.build_mips(params["emitter"]),
                tmips=tm.emitter.build_mips(),
                capacity=CHUNK * 8 + int(tcfg["eval_band_reserve"]))


@pytest.fixture(scope="module")
def split_pair():
    return _split_pair("float32")


@pytest.fixture(scope="module")
def split_pair_bf16():
    return _split_pair("bfloat16")


@pytest.mark.parametrize("variance,stage,pair", [
    (0.67, 1, "split_pair"), (0.4, 1, "split_pair"), (0.67, 0, "split_pair"),
    (0.67, 1, "split_pair_bf16")],
    ids=["sharp", "soft_overflow", "stage0", "sharp_bf16"])
def test_eval_forward_matches_jax(request, variance, stage, pair):
    """Sharp: inv_s ~ 812 as the bench sets it, every ray included.
    Soft: inv_s ~ 55 widens the bands, so the visibility compaction
    (``eval_visibility_frac``) overflows and excludes rays.  Sharp bf16:
    every MLP in bf16 with float32 products, as the flagship computes.
    The 8x8 image goes through in serial chunks of ``CHUNK`` rays, as
    the bench renders, and the stat counts are compared chunk by
    chunk."""
    p = request.getfixturevalue(pair)
    step = p["step"] if stage else 5
    params = {**p["params"], "variance": {
        **p["params"]["variance"], "variance": jnp.asarray(variance,
                                                           jnp.float32)}}
    kw = dict(stage=stage, capacity=p["capacity"], prefilter=True,
              banded=True)
    tm = p["tm"]
    with torch.no_grad():
        tm.variance.variance.fill_(variance)
    keys = ["comp_rgb_full", "opacity", "depth", "ray_included"] \
        + (["comp_rgb_phys_full"] if stage else [])
    counts = ("stat_live", "stat_vis", "stat_secondary_live", "num_samples")
    got, want = {k: [] for k in keys}, {k: [] for k in keys}
    for s in range(0, p["rays"].shape[0], CHUNK):
        rays = p["rays"][s:s + CHUNK]
        w = p["jm"].forward(params, _j(rays.numpy()),
                            occ_binary=_j(p["occ"].numpy()), mips=p["jmips"],
                            step=jnp.asarray(step, jnp.int32), rng=None,
                            train=False, background_color=jnp.ones((3,)),
                            **kw)
        g = tm(rays, occ_binary=p["occ"], mips=p["tmips"], step=step,
               background_color=torch.ones(3), bake=p["tbake"], **kw)
        for k in counts:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=f"{k}, chunk at {s}")
        assert int(g["stat_vis"]) > 0
        for k in keys:
            got[k].append(g[k].numpy())
            want[k].append(np.asarray(w[k]))
    got = {k: np.concatenate(v) for k, v in got.items()}
    want = {k: np.concatenate(v) for k, v in want.items()}
    for k in keys[:2] + keys[4:]:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-4,
                               atol=1e-4, err_msg="depth")
    np.testing.assert_array_equal(got["ray_included"], want["ray_included"])
    included = got["ray_included"]
    if variance < 0.5:
        assert 0 < included.sum() < included.size
    else:
        assert included.all()
    assert 0 < float(got["opacity"].max())
