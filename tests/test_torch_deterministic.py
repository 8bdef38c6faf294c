"""A training step under ``torch.use_deterministic_algorithms(True)``
against the JAX package, at the tiny presets.

Under the switch the port takes its deterministic path on every device
(``ops/scatter_sorted.py``): every encode's table gradient is the sorted
scatter (K2; its plain version here), every gather whose gradient is
taken has it as a backward, and the scans are ``blocked_cumsum`` (the
transmittance scan in float64).  The NeuS step (``tiny_neus_config``,
full grid) and the flagship's stage-1 step with the visibility
prefilter (``tiny_split_config``, step 30) are held to the existing
parity targets of ``tests/test_torch_neus.py`` and
``tests/test_torch_split_train.py``: the loss and its terms to rtol
1e-4, each gradient to 1e-3 of its tensor's largest entry.  The switch
is checked to reach every scatter: K1 is never called, the table's
gradient goes through K2 and so do the gathers' (float64 prefix sums of
the scans, float32 ray data).  The compactions, gathers in both modes
(torch's deterministic scatter adds a shared spare slot entry by entry),
give the JAX package's scatter's buffers bit for bit."""

import numpy as np
import pytest
import torch

from rise_sdf_tpu_torch import bridge, models, presets
from rise_sdf_tpu_torch.models.split_mixed_occ import _compact
from rise_sdf_tpu_torch.ops import march, scatter, scatter_sorted
from test_torch_neus import _assert_grad_close, _jax_loss_fn
from test_torch_neus import _batch as neus_batch
from test_torch_neus import _torch_batch, pair  # noqa: F401 (fixture)
from test_torch_split_train import _batch as split_batch
from test_torch_split_train import _jax_step_fn, _shell_grid
from test_torch_split_train import pairs  # noqa: F401 (fixture)


@pytest.fixture
def deterministic(monkeypatch):
    """The switch on for the test (as it was afterwards), K1 refused,
    and every call of the sorted scatter recorded as (rows, width,
    dtype)."""
    calls = []

    def record(real):
        def sorted_scatter(idx, vals, n, *period):
            calls.append((vals.shape[0], vals.shape[1], vals.dtype))
            return real(idx, vals, n, *period)
        return sorted_scatter

    def k1(*args, **kw):
        raise AssertionError("K1 called under the deterministic switch")

    for module in (scatter, scatter_sorted):
        monkeypatch.setattr(module, "scatter_add_sorted",
                            record(scatter_sorted.scatter_add_sorted))
    monkeypatch.setattr(scatter, "scatter_add", k1)
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield calls
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _grads_close(tsys, grads_j):
    want = bridge.flatten_params(grads_j)
    got = {bridge.jax_path(k): p.grad
           for k, p in tsys.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] is not None, k
        _assert_grad_close(got[k].numpy(), want[k], k)


def test_neus_step_matches_jax(pair, deterministic):  # noqa: F811
    jsys, jstate, tsys, _, path, _ = pair
    tsys.load_checkpoint(path)
    b = neus_batch(tsys, 4)
    grid = np.ones(32 ** 3, bool)
    (loss_j, aux_j), grads_j = _jax_loss_fn(jsys, b, grid, 5)(
        jstate["params"])
    tsys.model.zero_grad(set_to_none=True)
    loss_t, aux_t = tsys.forward_loss(_torch_batch(b),
                                      torch.from_numpy(grid), 5)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-4)
    for k in ("rgb_mse", "eikonal", "mask", "sparsity", "num_rays",
              "num_samples"):
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]),
                                   rtol=1e-4, err_msg=k)
    _grads_close(tsys, grads_j)
    levels = tsys.model.geometry.encoding.encoding.n_levels
    # the table's gradient: one encode of [capacity, levels, 8] rows
    assert (tsys.capacity * levels * 8, 2, torch.float32) in deterministic
    assert any(f == 1 and dt == torch.float64
               for _, f, dt in deterministic)  # the scan's start gathers


def test_split_stage1_step_matches_jax(pairs, deterministic):  # noqa: F811
    jsys, jstate, tsys, path = pairs[True]
    tsys.load_checkpoint(path)
    step = 30
    b = split_batch(tsys, 4)
    grid = _shell_grid()
    opts = tsys.train_options(step)
    assert opts["prefilter"]
    fn, dirs = _jax_step_fn(jsys, b, grid, step, opts["capacity"])
    (loss_j, aux_j), grads_j = fn(jstate["params"])
    tsys.model.zero_grad(set_to_none=True)
    loss_t, aux_t = tsys.forward_loss(_torch_batch(b),
                                      torch.from_numpy(grid), step,
                                      laplace_dirs=dirs, **opts)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-4)
    for k in sorted(set(aux_j) - {"inv_s"}):
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    _grads_close(tsys, grads_j)
    widths = {(f, dt) for _, f, dt in deterministic}
    # the table (F = 2), the scan's float64 prefix sums (F = 1) and the
    # texture's mip taps and ray data (float32, wider rows)
    assert (2, torch.float32) in widths and (1, torch.float64) in widths
    assert any(dt == torch.float32 and f > 2 for f, dt in widths), widths


def _scatter_compact(live, cap, *sources_fills):
    """The JAX package's compaction as a scatter: each live entry to its
    cumsum slot, the rest to one spare slot past the buffer, dropped."""
    pos = torch.cumsum(live, 0) - 1
    dest = torch.where(live & (pos < cap), pos, cap)
    return [torch.full((cap + 1,), fill, dtype=src.dtype).scatter_(
        0, dest, src)[:cap] for src, fill in sources_fills]


@pytest.mark.parametrize("capacity", [64, 3000, 9000],
                         ids=["overflow", "tight", "roomy"])
def test_compactions_under_the_switch_equal_the_scatters(capacity):
    """``march_rays`` and the flagship's ``_compact`` on the same rays
    and masks, the switch off and on: every buffer bit-equal to the
    JAX package's scatter (written out here) on the same live mask."""
    rng = np.random.default_rng(capacity)
    o = torch.from_numpy(rng.uniform(-0.2, 0.2, (64, 3)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((64, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    o = o - 2.5 * d
    lo, hi = torch.full((3,), -1.5), torch.full((3,), 1.5)
    grid = torch.from_numpy(rng.random(32 ** 3) < 0.5)
    keep = torch.from_numpy(rng.random(5000) < 0.4)
    t_near, t_far = march.ray_aabb_intersect(o, d, lo, hi)
    ts, te, live = march.candidate_intervals(t_near, t_far, 0.02, 128)
    t_mid = 0.5 * (ts + te)
    live = live & march.occupancy_lookup(
        grid, o[:, None, :] + d[:, None, :] * t_mid[..., None], lo, hi, 32)
    live = live.reshape(-1)
    want_ts, want_te, want_ray = _scatter_compact(
        live, capacity, (ts.reshape(-1), 0.0), (te.reshape(-1), 0.0),
        (torch.arange(64).repeat_interleave(128), 64))
    (want_src,) = _scatter_compact(keep, capacity // 3,
                                   (torch.arange(5000), 0))
    for on in (False, True):
        torch.use_deterministic_algorithms(on)
        try:
            rs = march.march_rays(
                o, d, aabb_min=lo, aabb_max=hi, step_size=0.02,
                num_samples=128, capacity=capacity, grid_binary=grid,
                grid_resolution=32)
            src, valid, _ = _compact(keep, capacity // 3)
        finally:
            torch.use_deterministic_algorithms(False)
        assert int(rs.num_live) == int(live.sum()) > 0
        for got, want in ((rs.t_starts, want_ts), (rs.t_ends, want_te),
                          (rs.ray_indices, want_ray), (src, want_src)):
            assert torch.equal(got, want)
        assert torch.equal(rs.valid, torch.arange(capacity) < live.sum())
        assert torch.equal(valid, torch.arange(capacity // 3) < keep.sum())


def test_secondary_compaction_under_the_switch_equals_the_scatter():
    """``compute_indirect_radiance`` with the live secondary samples
    compacted to 3/8 of the slots (the flagship yaml's fraction), the
    switch off and on: every output bit-equal, the overflow included,
    and each ray that fits equal (to 1e-6) to the uncompacted pass,
    which places every sample in its own slot as the scatter did."""
    cfg = presets.tiny_split_config()["model"]
    model = models.make(cfg["name"], cfg)
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.uniform(-0.4, 0.4, (48, 3)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((48, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    grid = torch.ones(model.grid_resolution ** 3, dtype=torch.bool)
    outs = []
    for on in (False, True):
        torch.use_deterministic_algorithms(on)
        try:
            with torch.no_grad():
                outs.append(model.compute_indirect_radiance(
                    o, d, grid, 30, frac=0.375))
        finally:
            torch.use_deterministic_algorithms(False)
    included = outs[0][2]
    assert not bool(included.all()) and bool(included.any())
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with torch.no_grad():
        full = model.compute_indirect_radiance(o, d, grid, 30, frac=1.0)
    assert bool(full[2].all()) and torch.equal(full[3], outs[0][3])
    for got, want in zip(outs[0][:2], full[:2]):
        torch.testing.assert_close(got[included], want[included],
                                   rtol=0, atol=1e-6)
