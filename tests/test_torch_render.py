"""Port parity: occupancy-pruned marching with compaction, the segmented
transmittance scan and per-ray accumulation against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu.ops import march as jmarch
from rise_sdf_tpu.ops import volrend as jvolrend
from rise_sdf_tpu_torch.ops import march, volrend

TOL = dict(rtol=1e-5, atol=1e-5)
R = 1.5
AABB = (np.full(3, -R, np.float32), np.full(3, R, np.float32))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = rng.uniform(-1.0, 1.0, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:3] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]  # axis-aligned slab edges
    return o.astype(np.float32), d.astype(np.float32)


def _grid(res, seed):
    return np.random.default_rng(seed).random(res ** 3) < 0.6


def test_ray_aabb_intersect_matches_jax():
    o, d = _rays(256, 0)
    want = jmarch.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(AABB[0]), jnp.asarray(AABB[1]))
    got = march.ray_aabb_intersect(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(AABB[0]),
                                   torch.from_numpy(AABB[1]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_occupancy_bits_and_lookup_match_jax():
    res = 16
    binary = _grid(res, 1)
    words_j = np.asarray(jmarch.pack_occupancy_bits(jnp.asarray(binary)))
    words_t = march.pack_occupancy_bits(torch.from_numpy(binary)).numpy()
    np.testing.assert_array_equal(words_t, words_j.astype(np.int64))
    pos = np.random.default_rng(2).uniform(-1.8, 1.8, (2000, 3)).astype(
        np.float32)
    want = jmarch.occupancy_lookup(jnp.asarray(binary), jnp.asarray(pos),
                                   jnp.asarray(AABB[0]), jnp.asarray(AABB[1]),
                                   res)
    got = march.occupancy_lookup(torch.from_numpy(binary),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(AABB[0]),
                                 torch.from_numpy(AABB[1]), res)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("capacity", [4096, 700], ids=["fits", "overflow"])
def test_march_rays_matches_jax(capacity):
    o, d = _rays(64, 3)
    res = 16
    binary = _grid(res, 4)
    kw = dict(step_size=1.732 * 2 * R / 128, num_samples=128,
              capacity=capacity, grid_resolution=res)
    want = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d),
                             aabb_min=jnp.asarray(AABB[0]),
                             aabb_max=jnp.asarray(AABB[1]),
                             grid_binary=jnp.asarray(binary), rng=None, **kw)
    got = march.march_rays(torch.from_numpy(o), torch.from_numpy(d),
                           aabb_min=torch.from_numpy(AABB[0]),
                           aabb_max=torch.from_numpy(AABB[1]),
                           grid_binary=torch.from_numpy(binary),
                           generator=None, **kw)
    for name in ("ray_indices", "valid", "ray_start", "ray_count",
                 "ray_included", "num_live"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("t_starts", "t_ends"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    if capacity == 700:
        assert not got.ray_included.all()
    assert int(got.num_live) > 0


def _buffer(seed, n_rays=40, capacity=600):
    """A compacted buffer with dead tail slots and rays without samples."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 25, n_rays)
    counts[::7] = 0
    ray_idx = np.repeat(np.arange(n_rays), counts)
    ray_end = np.cumsum(counts)
    ray_start = np.minimum(ray_end - counts, capacity).astype(np.int64)
    live = min(len(ray_idx), capacity)
    ray_indices = np.full(capacity, n_rays, np.int64)
    ray_indices[:live] = ray_idx[:live]
    valid = np.arange(capacity) < live
    # mostly thin samples with a few opaque ones: the scan's running
    # log-transmittance stays moderate, so its float32 rounding (summed in
    # another order by each framework) stays below the tolerance
    alphas = rng.uniform(0.0, 0.05, capacity).astype(np.float32)
    alphas[::29] = 0.9
    alphas[5] = 1.0
    return alphas, ray_start, ray_indices, valid, n_rays


@pytest.mark.parametrize("seed", [5, 6])
def test_render_weight_from_alpha_matches_jax(seed):
    alphas, ray_start, ray_indices, valid, n_rays = _buffer(seed)
    want = jvolrend.render_weight_from_alpha(
        jnp.asarray(alphas), jnp.asarray(ray_start.astype(np.int32)),
        jnp.asarray(ray_indices.astype(np.int32)), jnp.asarray(valid), n_rays)
    got = volrend.render_weight_from_alpha(
        torch.from_numpy(alphas), torch.from_numpy(ray_start),
        torch.from_numpy(ray_indices), torch.from_numpy(valid), n_rays)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("with_values", [True, False])
def test_accumulate_along_rays_matches_jax(with_values):
    alphas, _, ray_indices, _, n_rays = _buffer(7)
    values = np.random.default_rng(8).standard_normal(
        (len(alphas), 5)).astype(np.float32) if with_values else None
    want = jvolrend.accumulate_along_rays(
        jnp.asarray(alphas), jnp.asarray(ray_indices.astype(np.int32)),
        None if values is None else jnp.asarray(values), n_rays)
    got = volrend.accumulate_along_rays(
        torch.from_numpy(alphas), torch.from_numpy(ray_indices),
        None if values is None else torch.from_numpy(values), n_rays)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------- #
# The deterministic eval ops (taken on the card for eval renders; on the
# CPU torch's scan and index_add are sequential, and stay)

def _ray_major(n_rays, seed, dead=17, d=4):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, n_rays)
    counts[::7] = 0  # rays without samples
    ridx = np.concatenate([np.repeat(np.arange(n_rays), counts),
                           np.full(dead, n_rays)])
    src = rng.standard_normal((ridx.shape[0], d)).astype(np.float32)
    return torch.from_numpy(ridx), torch.from_numpy(src)


@pytest.mark.parametrize("shape", [(1,), (1023,), (1024,), (1025, 3),
                                   (70000,), (5000, 1)])
def test_blocked_cumsum_matches_a_float64_scan(shape):
    x = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(
        shape).astype(np.float32))
    want = torch.cumsum(x.double(), 0)
    got = volrend.blocked_cumsum(x)
    assert got.shape == x.shape and got.dtype == torch.float32
    # float32 sums of at most ~70,000 unit normals: |prefix| < ~600
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(volrend.blocked_cumsum(x.double()).numpy(),
                               want.numpy(), rtol=0, atol=1e-10)


def test_sorted_segment_sum_matches_index_add():
    n = 300
    ridx, src = _ray_major(n, 0)
    want = torch.zeros((n + 1, 4), dtype=torch.float64).index_add(
        0, ridx, src.double())[:n]
    got = volrend.sorted_segment_sum(src, ridx, n)
    assert got.dtype == torch.float32 and got.shape == (n, 4)
    # the float64 prefix difference rounds once to float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert bool((got[::7] == 0).all())


def test_deterministic_flag_keeps_the_cpu_ops():
    n = 64
    ridx, src = _ray_major(n, 1, d=1)
    alphas = torch.sigmoid(src[:, 0])
    starts = torch.searchsorted(ridx, torch.arange(n))
    valid = ridx < n
    plain = volrend.render_weight_from_alpha(alphas, starts, ridx, valid, n)
    det = volrend.render_weight_from_alpha(alphas, starts, ridx, valid, n,
                                           deterministic=True)
    for a, b in zip(plain, det):
        assert torch.equal(a, b)
    vals = src.repeat(1, 3)
    assert torch.equal(
        volrend.accumulate_along_rays(plain[0], ridx, vals, n),
        volrend.accumulate_along_rays(plain[0], ridx, vals, n,
                                      deterministic=True))
