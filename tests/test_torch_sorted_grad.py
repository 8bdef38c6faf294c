"""The port's deterministic table gradient (``grad_impl='sorted'``, K2)
against the JAX package's ``apply(..., grad_impl='sorted')``, and K2's
plain version against a float64 sum.

The four cases of ``tests/test_hashgrid_vjp.py`` (forward, table
gradient, x gradient, progressive mask) hold the port's sorted encode
against JAX's sorted one at JAX's own tolerance, ``rtol=1e-3,
atol=1e-4`` (JAX differences float32 prefix sums over the whole stream).
The port's table gradient is also held to a float64 sum of the same
cotangents at 1e-6 relative: it sums each entry exactly and rounds
once.  K2's plain version is held to float64 at 1e-6 relative for F =
1, 2, 3 and 13, float32 and float64, on index streams laid out as the
encodes lay them: ``[N, 16, 8]`` corner rows (period 128), the shared
probes' ``[N, 3, 32]`` rows (period 96) and a flat stream (period 1).
Inputs come from numpy seeds.

K2's plain version is the kernel's fixed-point arithmetic in torch ops
(the card's tests hold the kernel bit-equal to it), so the cases below
pin that arithmetic down on the CPU: it is order-free (bit-equal under
any permutation of the rows), and per entry within one ulp of the
dtype plus ``count * 2^-60 * max|v|`` of the exact sum (``math.fsum``)
and, allowing for the float64 sum's own rounding, of a float64 sum,
where an entry far below the call's largest value keeps that accuracy
against its own (each entry takes its own scale); NaN and infinities
give what a float sum gives; and it holds at the ends of the range: no
rows, the largest finite values, a lone tiny value, the smallest
subnormal, and row counts on either side of a power of two, where the
scales' exponents move."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rise_sdf_tpu.models.geometry import VolumeSDF as JaxVolumeSDF
from rise_sdf_tpu.ops.hashgrid import HashGridEncoding as JaxHashGrid
from rise_sdf_tpu.presets import geometry_cfg
from rise_sdf_tpu_torch import bridge
from rise_sdf_tpu_torch.models.geometry import VolumeSDF
from rise_sdf_tpu_torch.ops import hashgrid, scatter, scatter_sorted
from rise_sdf_tpu_torch.ops.hashgrid import HashGridEncoding
from rise_sdf_tpu_torch.ops.scatter_sorted import (
    MAX_ROWS, index_select, scatter_add_sorted, scatter_add_sorted_plain)
from test_torch_streams import probe_encode_rows, ray_encode_rows

# JAX's tolerance for its sorted gradients (tests/test_hashgrid_vjp.py)
JAX_TOL = dict(rtol=1e-3, atol=1e-4)
CFG = {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
       "log2_hashmap_size": 10, "base_resolution": 4,
       "per_level_scale": 1.7}
PROGRESSIVE = dict(CFG, otype="ProgressiveBandHashGrid", start_level=2,
                   start_step=0, update_steps=100)


@pytest.fixture
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the test, the
    switch as it was afterwards."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _table(cfg, seed):
    shape = (cfg["n_levels"], 2 ** cfg["log2_hashmap_size"],
             cfg["n_features_per_level"])
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _points(n, seed, lo=0.01, hi=0.99):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def _pair(cfg, table):
    te = HashGridEncoding(3, cfg)
    te.load_state_dict({"table": torch.from_numpy(table)})
    return JaxHashGrid(3, cfg), te


def _recorded_sorted_grad(te, fn):
    """Run ``fn`` (the port's loss, from the encode) backward with every
    lookup recorded; -> the table gradient and its float64 sum of the
    recorded rows and cotangents."""
    seen = []
    lookup = hashgrid.table_grad_lookup

    def recording_lookup(table, rows, *rest):
        vals = lookup(table, rows, *rest)
        vals.retain_grad()
        seen.append((rows, vals))
        return vals

    hashgrid.table_grad_lookup = recording_lookup
    try:
        fn().backward()
    finally:
        hashgrid.table_grad_lookup = lookup
    f = te.n_features_per_level
    ref = np.zeros((te.n_levels * te.table_size, f))
    for rows, vals in seen:
        np.add.at(ref, rows.reshape(-1).numpy(),
                  vals.grad.reshape(-1, f).double().numpy())
    return te.table.grad.numpy(), ref.reshape(te.table.shape)


def _assert_f64(got, ref, what):
    """``got`` within 1e-6 of ``ref``'s magnitude, entry by entry."""
    err = np.abs(got.astype(np.float64) - ref)
    assert (err <= 1e-6 * np.abs(ref) + 1e-12).all(), (
        what, float(err.max()))


def test_forward_identical():
    jax_enc, te = _pair(CFG, _table(CFG, 0))
    x = _points(64, 1)
    table = jnp.asarray(te.table.detach().numpy())
    want = jax.jit(lambda t, xx: jax_enc.apply(
        {"table": t}, xx, grad_impl="sorted"))(table, jnp.asarray(x))
    for impl in ("plain", "sorted"):
        got = te(torch.from_numpy(x), grad_impl=impl)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_table_grads_match():
    table = _table(CFG, 0)
    jax_enc, te = _pair(CFG, table)
    x = _points(64, 1)
    w = np.random.default_rng(2).standard_normal(8).astype(np.float32)

    def loss(p):
        return jnp.sum(jax_enc.apply(p, jnp.asarray(x), grad_impl="sorted")
                       * jnp.asarray(w)[None] ** 2)

    want = np.asarray(jax.jit(jax.grad(loss))(
        {"table": jnp.asarray(table)})["table"])
    got, ref = _recorded_sorted_grad(te, lambda: torch.sum(
        te(torch.from_numpy(x), grad_impl="sorted")
        * torch.from_numpy(w)[None] ** 2))
    np.testing.assert_allclose(got, want, **JAX_TOL)
    _assert_f64(got, ref, "sorted table gradient vs float64")
    assert np.abs(got).max() > 0


def test_x_grads_match():
    table = _table(CFG, 3)
    jax_enc, te = _pair(CFG, table)
    x = _points(32, 4, 0.05, 0.95)

    def loss(xx):
        return jnp.sum(jnp.sin(jax_enc.apply(
            {"table": jnp.asarray(table)}, xx, grad_impl="sorted") * 50))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sum(torch.sin(te(xt, grad_impl="sorted") * 50)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, **JAX_TOL)


def test_progressive_mask_grads():
    table = _table(PROGRESSIVE, 0)
    jax_enc, te = _pair(PROGRESSIVE, table)
    x = _points(16, 1, 0.0, 1.0)

    def loss(p):
        return jnp.sum(jax_enc.apply(p, jnp.asarray(x), step=0,
                                     grad_impl="sorted"))

    want = np.asarray(jax.jit(jax.grad(loss))(
        {"table": jnp.asarray(table)})["table"])
    got, ref = _recorded_sorted_grad(te, lambda: torch.sum(
        te(torch.from_numpy(x), step=0, grad_impl="sorted")))
    np.testing.assert_allclose(got, want, atol=1e-5)
    _assert_f64(got, ref, "progressive sorted gradient vs float64")
    assert np.abs(got[2:]).max() == 0.0  # masked levels


@pytest.mark.parametrize("encode", ["forward", "encode_with_grad",
                                    "encode_axis_probes"])
def test_every_encode_takes_the_sorted_gradient(encode):
    """The three encodes: the sorted table gradient equals the plain one
    (to float32 rounding of the sums) and the float64 sum, and the x
    gradient is the same function either way."""
    cfg = dict(CFG, log2_hashmap_size=12)
    te = HashGridEncoding(3, cfg)
    te.load_state_dict({"table": torch.from_numpy(_table(cfg, 5))})
    x = _points(200, 6, 0.1, 0.9)
    eps = 0.5 / te.resolutions[-1]
    probes = np.repeat(x[None], 6, 0)
    for p in range(6):
        probes[p, :, p // 2] += eps if p % 2 == 0 else -eps
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (7, 200, 8)).astype(np.float32))

    def loss(impl, xt):
        if encode == "forward":
            out = te(xt, grad_impl=impl)[None]
        elif encode == "encode_with_grad":
            f, jac = te.encode_with_grad(xt, grad_impl=impl)
            out = torch.stack([f, *jac])
        else:
            out = te.encode_axis_probes(xt, torch.from_numpy(probes),
                                        (0, 0, 1, 1, 2, 2), levels=(2, 4),
                                        grad_impl=impl)
        return torch.sum(out * cot[:out.shape[0]])

    xp = torch.from_numpy(x).requires_grad_(True)
    loss("plain", xp).backward()
    plain = te.table.grad.clone()
    te.table.grad = None
    xs = torch.from_numpy(x).requires_grad_(True)
    got, ref = _recorded_sorted_grad(te, lambda: loss("sorted", xs))
    _assert_f64(got, ref, encode)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(xs.grad.numpy(), xp.grad.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert np.abs(got).max() > 0


def test_geometry_raw_takes_grad_impl():
    """``VolumeSDF.raw`` / ``sdf(..., grad_impl='sorted')`` against JAX's
    ``raw(..., grad_impl='sorted')``: features and table gradient."""
    cfg = geometry_cfg("analytic")
    jg = JaxVolumeSDF(cfg)
    params = jg.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        lambda v: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32),
        params)
    tg = VolumeSDF(cfg)
    tg.load_state_dict({k: torch.from_numpy(np.array(
        bridge.flatten_params({"geometry": params})[bridge.jax_path(
            "geometry." + k)])) for k in tg.state_dict()})
    x = (_points(128, 9) * 2.0 - 1.0) * 0.8
    cot = np.random.default_rng(10).standard_normal(
        (128, tg.feature_dim)).astype(np.float32)

    def loss(p):
        return jnp.sum(jg.raw(p, jnp.asarray(x), grad_impl="sorted") * cot)

    want = jax.jit(jax.grad(loss))(params)["encoding"]["table"]
    torch.sum(tg.raw(torch.from_numpy(x), grad_impl="sorted")
              * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(tg.encoding.encoding.table.grad.numpy(),
                               np.asarray(want), **JAX_TOL)
    np.testing.assert_allclose(
        tg.sdf(torch.from_numpy(x), grad_impl="sorted").detach().numpy(),
        np.asarray(jax.jit(lambda p, xx: jg.sdf(p, xx, grad_impl="sorted"))(
            params, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def _stream(kind):
    """(idx [M] int32, table size, the layout's period)."""
    if kind == "corners":
        rows, t = ray_encode_rows(8, 125)
        return rows.reshape(-1), t, 128
    if kind == "probes":
        rows, t = probe_encode_rows(4, 250)
        return rows.reshape(-1), t, 96
    idx = np.random.default_rng(11).integers(0, 3000, 50000)
    return torch.from_numpy(idx.astype(np.int32)), 3000, 1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("f", [1, 2, 3, 13])
@pytest.mark.parametrize("kind", ["corners", "probes", "flat"])
def test_plain_version_matches_float64(kind, f, dtype):
    idx, t, period = _stream(kind)
    assert idx.shape[0] % period == 0
    vals = np.random.default_rng(f).standard_normal(
        (idx.shape[0], f)).astype(dtype)
    got = scatter_add_sorted(idx, torch.from_numpy(vals), t)
    assert got.dtype == getattr(torch, dtype) and got.shape == (t, f)
    ref = np.zeros((t, f))
    np.add.at(ref, idx.numpy(), vals.astype(np.float64))
    _assert_f64(got.numpy(), ref, f"{kind} F={f} {dtype}")
    # every row the stream names is touched, the others are zero
    hit = np.zeros(t, bool)
    hit[idx.numpy()] = True
    assert not got.numpy()[~hit].any()


def test_wrapper_checks_its_inputs_and_counts_no_cpu_launch():
    idx = torch.tensor([0, 2, 2], dtype=torch.int32)
    vals = torch.ones((3, 2))
    before = scatter_add_sorted.launches
    np.testing.assert_array_equal(
        scatter_add_sorted(idx, vals, 4).numpy(),
        [[1, 1], [0, 0], [2, 2], [0, 0]])
    assert scatter_add_sorted.launches == before
    with pytest.raises(TypeError):
        scatter_add_sorted(idx.long(), vals, 4)
    with pytest.raises(TypeError):
        scatter_add_sorted(idx, vals.half(), 4)
    with pytest.raises(ValueError):
        scatter_add_sorted(idx, vals[:2], 4)
    with pytest.raises(ValueError):
        scatter_add_sorted(idx, vals.t().contiguous().t(), 4)
    with pytest.raises(ValueError, match="grad_impl"):
        scatter.table_grad_lookup(vals, idx, "atomic")


def test_gather_backward_is_the_sorted_scatter(deterministic, monkeypatch):
    """Under the switch ``index_select``'s backward goes through
    ``scatter_add_sorted``, and its double backward through the gather
    again (gradcheck and gradgradcheck in float64)."""
    calls = []
    real = scatter_sorted.scatter_add_sorted

    def counting(idx, vals, n):
        calls.append((tuple(vals.shape), vals.dtype))
        return real(idx, vals, n)

    monkeypatch.setattr(scatter_sorted, "scatter_add_sorted", counting)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (20, 3))).requires_grad_(True)
    idx = torch.from_numpy(np.random.default_rng(13).integers(0, 20, 31))
    assert torch.autograd.gradcheck(lambda t: index_select(t, idx), (x,))
    assert torch.autograd.gradgradcheck(lambda t: index_select(t, idx), (x,))
    assert calls and all(shape == (31, 3) for shape, _ in calls)
    y = torch.arange(5.0, requires_grad=True)
    index_select(y, torch.tensor([4, 4, 0])).sum().backward()
    np.testing.assert_array_equal(y.grad.numpy(), [1, 0, 0, 0, 2])


def test_gather_without_the_switch_is_index_select():
    assert not torch.are_deterministic_algorithms_enabled()
    x = torch.arange(6.0, requires_grad=True)
    out = index_select(x, torch.tensor([5, 1]))
    assert out.grad_fn.name() == "IndexSelectBackward0"


def _fixed_point_tolerance(got, ref, count, max_abs):
    """Per entry: one ulp of ``got``'s dtype at the entry plus ``count *
    2^-60 * max|v|``."""
    dtype = got.dtype
    ulp = np.maximum(np.spacing(np.abs(ref).astype(dtype)),
                     np.spacing(np.abs(got))).astype(np.float64)
    return ulp + count * 2.0 ** -60 * max_abs


def _exact_rows(idx, vals, rows):
    """``math.fsum`` of every column of the given table rows."""
    return np.array([[math.fsum(vals[idx == r, c].astype(np.float64))
                      for c in range(vals.shape[1])] for r in rows])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("f", [1, 2, 3, 13])
@pytest.mark.parametrize("kind", ["corners", "probes", "flat"])
def test_fixed_point_within_its_tolerance(kind, f, dtype):
    """Per entry within one ulp plus ``count * 2^-60 * max|v|`` of the
    exact sum on 64 of the rows, and of a float64 sum on all of them (its
    own rounding, ``count * 2^-53 * sum|v|``, allowed for); values over
    twelve binades, so the small ones lean on the fixed point's low
    words."""
    idx, t, period = _stream(kind)
    rng = np.random.default_rng(100 + f)
    vals = (rng.standard_normal((idx.shape[0], f))
            * np.exp2(rng.integers(-12, 1, (idx.shape[0], 1)))).astype(dtype)
    got = scatter_add_sorted(idx, torch.from_numpy(vals), t, period).numpy()
    rows = idx.numpy()
    count = np.bincount(rows, minlength=t)[:, None].astype(np.float64)
    max_abs = float(np.abs(vals).max())
    ref = np.zeros((t, f))
    np.add.at(ref, rows, vals.astype(np.float64))
    mag = np.zeros((t, f))
    np.add.at(mag, rows, np.abs(vals.astype(np.float64)))
    err = np.abs(got.astype(np.float64) - ref)
    tol = _fixed_point_tolerance(got, ref, count, max_abs)
    assert (err <= tol + count * 2.0 ** -53 * mag).all(), (kind, f, dtype)
    some = np.unique(rows)[::max(1, len(np.unique(rows)) // 64)][:64]
    exact = _exact_rows(rows, vals, some)
    err = np.abs(got[some].astype(np.float64) - exact)
    assert (err <= _fixed_point_tolerance(got[some], exact, count[some],
                                          max_abs)).all(), (kind, f, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2 ** 32 - 1), m=st.integers(0, 300),
       t=st.integers(1, 12), f=st.integers(1, 3),
       spread=st.integers(0, 60), non_finite=st.booleans())
def test_fixed_point_is_order_free(dtype, seed, m, t, f, spread, non_finite):
    """The same rows in a random order give the same bits (NaNs compared
    by place), whatever the spread of magnitudes."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, t, m).astype(np.int32)
    vals = (rng.standard_normal((m, f))
            * np.exp2(rng.integers(-spread, 1, (m, f)))).astype(dtype)
    if non_finite and m:
        at = rng.integers(0, m, 3)
        vals[at, 0] = [np.inf, -np.inf, np.nan][:len(at)]
    perm = rng.permutation(m)
    a = scatter_add_sorted(torch.from_numpy(idx), torch.from_numpy(vals),
                           t).numpy()
    b = scatter_add_sorted(torch.from_numpy(idx[perm]),
                           torch.from_numpy(vals[perm]), t).numpy()
    nan = np.isnan(a)
    assert (nan == np.isnan(b)).all()
    assert (a[~nan].view(np.uint8) == b[~nan].view(np.uint8)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fixed_point_non_finite_rows(dtype):
    """NaN, +Inf, -Inf and both infinities, alone and among finite
    values: the entries a float sum gives, the finite ones exact."""
    inf, nan = math.inf, math.nan
    idx = torch.tensor([0, 0, 1, 1, 2, 3, 3, 4, 5, 5, 6], dtype=torch.int32)
    col = torch.tensor([1.5, nan, inf, 2.0, -inf, inf, -inf, 0.25, -inf,
                        -inf, 3.0], dtype=dtype)
    vals = torch.stack([col, col.flip(0)], 1).contiguous()
    got = scatter_add_sorted(idx, vals, 8)
    want = torch.zeros((8, 2), dtype=torch.float64).index_add_(
        0, idx.long(), vals.double()).to(dtype)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[~torch.isnan(got)], want[~torch.isnan(want)])
    assert torch.isnan(got[[0, 3], 0]).all() and got[1, 0] == inf
    assert got[2, 0] == -inf and got[6, 0] == 3.0 and got[7].eq(0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["empty", "largest", "tiny", "subnormal",
                                  "bits_1023", "bits_1024"])
def test_fixed_point_at_the_ends_of_its_range(case, dtype):
    """No rows; the largest finite magnitude (exact alone, 0 against its
    negation, +Inf twice); one nonzero row of 2^-120; the smallest
    subnormal; and 1023 / 1024 rows, around the power of two where the
    scales drop a bit (``94 - bitlen(M)``), every fourth one of one value
    into one row (the largest sum the integers must hold) beside small
    ones."""
    info = np.finfo(dtype)
    if case == "empty":
        got = scatter_add_sorted(torch.zeros(0, dtype=torch.int32),
                                 torch.from_numpy(np.zeros((0, 3), dtype)), 4)
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        assert got.shape == (4, 3) and not got.any()
        return
    if case in ("largest", "tiny", "subnormal"):
        v = {"largest": info.max, "tiny": dtype(2.0 ** -120),
             "subnormal": info.smallest_subnormal}[case]
        idx = np.array([1, 2, 2, 3, 3, 4], np.int32)
        vals = np.array([v, v, -v, v, v, 0], dtype)[:, None]
        if case != "largest":
            idx, vals = idx[:2], vals[:2] * 0  # one nonzero row
            vals[0] = v
        got = scatter_add_sorted(torch.from_numpy(idx),
                                 torch.from_numpy(vals), 5).numpy()
        want = np.zeros((5, 1), dtype)
        want[1] = v
        if case == "largest":
            want[3] = np.inf
        assert (got.view(np.uint8) == want.view(np.uint8)).all(), got
        return
    m = int(case.split("_")[1])
    rng = np.random.default_rng(m)
    v = dtype(1.75 * 8)
    idx = np.where(np.arange(m) % 4 == 0, 0,
                   rng.integers(1, 7, m)).astype(np.int32)
    vals = np.where(idx[:, None] == 0, v, (rng.standard_normal((m, 2))
                                           * 1e-6)).astype(dtype)
    vals[idx == 0, 1] = -v
    got = scatter_add_sorted(torch.from_numpy(idx), torch.from_numpy(vals),
                             7).numpy()
    n0 = int((idx == 0).sum())
    assert got[0, 0] == n0 * v and got[0, 1] == -n0 * v
    exact = _exact_rows(idx, vals, range(7))
    count = np.bincount(idx, minlength=7)[:, None].astype(np.float64)
    err = np.abs(got.astype(np.float64) - exact)
    assert (err <= _fixed_point_tolerance(got, exact, count, float(v))).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fixed_point_keeps_small_entries(dtype):
    """Entries whose values lie far below the call's largest (2^-100 and
    2^-120 of it, and one row mixing both ends) keep their accuracy:
    each within one ulp plus ``count * 2^-60`` of its own largest
    magnitude of the exact sum, and within 1e-6 of its magnitudes."""
    rng = np.random.default_rng(15)
    idx = rng.integers(0, 6, 3000).astype(np.int32)
    scale = np.array([2.0 ** 40, 2.0 ** -60, 2.0 ** -80, 1.0, 2.0 ** -60,
                      2.0 ** 40])[idx]
    scale[(idx == 5) & (np.arange(3000) % 2 == 0)] = 2.0 ** -80
    vals = (rng.standard_normal((3000, 2)) * scale[:, None]).astype(dtype)
    got = scatter_add_sorted(torch.from_numpy(idx), torch.from_numpy(vals),
                             7).numpy()
    exact = _exact_rows(idx, vals, range(7))
    err = np.abs(got.astype(np.float64) - exact)
    count = np.bincount(idx, minlength=7)[:, None].astype(np.float64)
    own = np.zeros((7, 2))
    np.maximum.at(own, idx, np.abs(vals.astype(np.float64)))
    assert (err <= _fixed_point_tolerance(got, exact, count, own)).all()
    mag = np.zeros((7, 2))
    np.add.at(mag, idx, np.abs(vals.astype(np.float64)))
    assert (err[:5] <= 1e-6 * mag[:5]).all()


def test_wrapper_checks_period_and_rows():
    """``period`` as K1's (an int >= 1; it changes no bit), and at most
    ``MAX_ROWS`` rows (checked before any memory is touched)."""
    idx = torch.tensor([0, 2, 2, 1, 0, 2], dtype=torch.int32)
    vals = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (6, 2)))
    base = scatter_add_sorted(idx, vals, 3)
    for period in (2, 3, 4):
        assert torch.equal(scatter_add_sorted(idx, vals, 3, period), base)
    assert torch.equal(scatter_add_sorted_plain(idx, vals, 3), base)
    with pytest.raises(TypeError):
        scatter_add_sorted(idx, vals, 3, 2.0)
    with pytest.raises(TypeError):
        scatter_add_sorted(idx, vals, 3, True)
    with pytest.raises(ValueError):
        scatter_add_sorted(idx, vals, 3, 0)
    big = torch.empty(MAX_ROWS + 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="at most"):
        scatter_add_sorted(big, torch.empty((MAX_ROWS + 1, 2),
                                            device="meta"), 3)
