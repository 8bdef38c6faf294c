"""Contended index streams shared by the kernel tests (K1 scatter-add,
G1 row gather), and checks that they hold the structure those tests
rely on: rows inside their table, and runs of equal rows down the
columns of the ``[N, L, 8]`` layout.

Imports only numpy, torch and the port, so ``tests/test_torch_cuda.py``
can use it where jax is absent."""

import numpy as np
import pytest
import torch

from rise_sdf_tpu_torch.ops import hashgrid


def ray_encode_rows(n_rays, n_samples, seed=0):
    """[n_rays * n_samples, 16, 8] int32 rows that the port's hash encode
    builds for samples along a few rays (ray-major, as the march
    compacts them), and the flattened table's size.  16 levels of 2^12
    rows from resolution 4 by 1.3: levels 0-5 are dense, where
    neighbouring samples share rows; the rest are hashed."""
    enc = hashgrid.HashGridEncoding(3, {
        "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 12,
        "base_resolution": 4, "per_level_scale": 1.3})
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.3, 0.7, (n_rays, 1, 3))
    d = rng.standard_normal((n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(-0.25, 0.25, n_samples)[None, :, None]
    x = np.clip(o + t * d, 0.0, 1.0).reshape(-1, 3).astype(np.float32)
    seen = {}
    lookup = hashgrid.table_grad_lookup

    def recording_lookup(table, rows, *rest):
        seen["rows"] = rows
        return lookup(table, rows, *rest)

    hashgrid.table_grad_lookup = recording_lookup
    try:
        with torch.no_grad():
            enc(torch.from_numpy(x))
    finally:
        hashgrid.table_grad_lookup = lookup
    return seen["rows"], enc.n_levels * enc.table_size


def probe_encode_rows(n_rays, n_samples, seed=0):
    """[n_rays * n_samples, 3, 32] int32 rows of the shared-probe encode
    (the hybrid-FD fine band, 3 levels of 32-point neighbourhoods) for
    samples along a few rays, from the 16-level grid of
    ``ray_encode_rows`` with levels 13-15 in the band, and the
    flattened table's size."""
    enc = hashgrid.HashGridEncoding(3, {
        "n_levels": 16, "n_features_per_level": 2, "log2_hashmap_size": 12,
        "base_resolution": 4, "per_level_scale": 1.3})
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.3, 0.7, (n_rays, 1, 3))
    d = rng.standard_normal((n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(-0.25, 0.25, n_samples)[None, :, None]
    u = np.clip(o + t * d, 0.0, 1.0).reshape(-1, 3).astype(np.float32)
    eps = 1.0 / enc.resolutions[-1]
    probes = np.repeat(u[None], 6, 0)
    for p in range(6):
        probes[p, :, p // 2] = np.clip(
            probes[p, :, p // 2] + (eps if p % 2 == 0 else -eps), 0.0, 1.0)
    seen = {}
    lookup = hashgrid.table_grad_lookup

    def recording_lookup(table, rows, *rest):
        seen["rows"] = rows
        return lookup(table, rows, *rest)

    hashgrid.table_grad_lookup = recording_lookup
    try:
        with torch.no_grad():
            enc.encode_axis_probes(torch.from_numpy(u),
                                   torch.from_numpy(probes),
                                   (0, 0, 1, 1, 2, 2), levels=(13, 16))
    finally:
        hashgrid.table_grad_lookup = lookup
    return seen["rows"], enc.n_levels * enc.table_size


def dense17_rows(n, seed=0):
    """[n, 1, 8] rows of a dense 17^3 level (resolution 16) for samples
    along one ray in steps shorter than a cell: runs of equal rows."""
    rng = np.random.default_rng(seed)
    o, d = rng.uniform(0.2, 0.8, 3), rng.standard_normal(3)
    x = np.clip(o + np.linspace(-0.3, 0.3, n)[:, None] * d / np.linalg.norm(
        d), 0.0, 1.0 - 1e-6) * 16
    c = np.floor(x).astype(np.int64)[:, None, :] + np.array(
        [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)])
    flat = c[..., 0] + 17 * (c[..., 1] + 17 * c[..., 2])
    return torch.from_numpy(flat.astype(np.int32)[:, None, :]), 17 ** 3


def _repeat_share(rows):
    """Per level, the share of entries equal to the entry one sample
    before in the same column."""
    r = rows.numpy()
    return (r[1:] == r[:-1]).mean(axis=(0, 2))


@pytest.mark.parametrize("stream", ["rays", "dense17"])
def test_stream_rows_lie_in_their_levels(stream):
    rows, t = ray_encode_rows(8, 125) if stream == "rays" \
        else dense17_rows(1001)
    n_levels = rows.shape[1]
    assert rows.dtype == torch.int32 and rows.shape[2] == 8
    level = np.arange(n_levels)[None, :, None] * (t // n_levels)
    r = rows.numpy()
    assert ((r >= level) & (r < level + t // n_levels)).all()


def test_ray_rows_repeat_down_coarse_columns():
    """Ray-major samples share rows on the coarse levels, less on the
    fine ones: the runs K1 adds up before its atomics."""
    share = _repeat_share(ray_encode_rows(8, 125)[0])
    assert share[0] > 0.8 and share[0] > share[-1]
    assert (np.diff(share[:6]) <= 0).all()


def test_dense17_rows_repeat_and_pair_x_neighbours():
    """Steps shorter than a cell repeat rows; corners c and c + 4 are
    x-neighbours, one row apart on a dense level."""
    rows, _ = dense17_rows(1001)
    assert _repeat_share(rows)[0] > 0.5
    r = rows.numpy()[:, 0]
    np.testing.assert_array_equal(r[:, 4:] - r[:, :4], 1)


def test_probe_rows_hold_the_32_point_layout():
    """The shared-probe encode's [N, 3, 32] rows: levels 13-15 of the
    flattened table, the 8 cell corners first, and neighbouring samples
    along a ray sharing rows down the columns."""
    rows, t = probe_encode_rows(4, 250)
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (1000, 3, 32)
    level = np.arange(13, 16)[None, :, None] * (t // 16)
    r = rows.numpy()
    assert ((r >= level) & (r < level + t // 16)).all()
    corners, _ = ray_encode_rows(4, 250)
    np.testing.assert_array_equal(r[:, :, :8], corners.numpy()[:, 13:])
    assert (_repeat_share(rows) > 0.3).all()
