"""Port parity: hash-table scatter-add (kernel K1's plain version) and the
TableGradLookup autograd function against the JAX package's Pallas
kernel (interpret mode) and its XLA reference.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against ``scatter_add_plain`` there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu.ops.scatter_pallas import (
    pallas_scatter_add,
    scatter_add_reference,
    table_grad_lookup,
)
from rise_sdf_tpu_torch.ops import scatter as port_scatter
from rise_sdf_tpu_torch.ops.scatter import (
    TableGradLookup,
    scatter_add,
    scatter_add_plain,
)
from test_torch_streams import dense17_rows, ray_encode_rows


def _inputs(m, t, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, t, size=(m,), dtype=np.int32)
    vals = rng.standard_normal((m, 2)).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("m,t", [(3 * 8192 + 100, 4096), (8192, 35937)],
                         ids=["padded_rows", "odd_table"])
def test_scatter_add_plain_matches_pallas_and_xla(m, t):
    idx, vals = _inputs(m, t, seed=m)
    got = scatter_add_plain(torch.from_numpy(idx), torch.from_numpy(vals), t)
    pallas = pallas_scatter_add(jnp.asarray(idx), jnp.asarray(vals), t, True)
    xla = scatter_add_reference(jnp.asarray(idx), jnp.asarray(vals), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla),
                               rtol=1e-5, atol=1e-5)


def test_scatter_add_cpu_takes_plain_version_without_launch():
    idx, vals = _inputs(5000, 300, seed=1)
    before = scatter_add.launches
    got = scatter_add(torch.from_numpy(idx), torch.from_numpy(vals), 300)
    want = scatter_add_plain(torch.from_numpy(idx), torch.from_numpy(vals),
                             300)
    assert scatter_add.launches == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("case", ["int64_idx", "f64_vals", "shape",
                                  "noncontiguous"])
def test_scatter_add_rejects_bad_inputs(case):
    idx = torch.zeros(8, dtype=torch.int32)
    vals = torch.zeros(8, 2)
    if case == "int64_idx":
        idx = idx.long()
    elif case == "f64_vals":
        vals = vals.double()
    elif case == "shape":
        vals = torch.zeros(7, 2)
    else:
        vals = torch.zeros(2, 8).t()
    with pytest.raises((TypeError, ValueError)):
        scatter_add(idx, vals, 16)


def _within_f64(got, idx, vals, t):
    """Per entry |got - ref64| <= 1e-5 * S + 1e-7, S the sum of |v|
    landing on the entry: float32 sums in another order than float64's
    (up to a few hundred contributions per entry here)."""
    ref = np.zeros((t, 2))
    np.add.at(ref, idx, vals.astype(np.float64))
    s = np.zeros((t, 2))
    np.add.at(s, idx, np.abs(vals.astype(np.float64)))
    err = np.abs(np.asarray(got, np.float64) - ref)
    assert (err <= 1e-5 * s + 1e-7).all(), float(err.max())


@pytest.mark.parametrize("stream", ["dense17", "rays"])
@pytest.mark.parametrize("period", [1, 8, 128])
def test_scatter_add_period_on_contended_streams_matches_jax(stream, period):
    """Streams whose neighbouring entries name the same row (a 17^3 dense
    level; ray-ordered [N, 16, 8] rows of the port's encode), cut so that
    M is no multiple of P or of 32: the port's scatter with ``period``
    against JAX's ``scatter_add_reference`` and ``pallas_scatter_add``
    (interpret mode), each within the float32 bound of a float64 sum."""
    if stream == "dense17":
        rows, t = dense17_rows(1001)
    else:
        rows, t = ray_encode_rows(4, 75)
    idx = rows.reshape(-1).numpy()[:-5]
    assert idx.size % 32 and (idx.size % period or period == 1)
    vals = np.random.default_rng(period).standard_normal(
        (idx.size, 2)).astype(np.float32)
    got = scatter_add(torch.from_numpy(idx), torch.from_numpy(vals), t,
                      period)
    np.testing.assert_array_equal(
        got.numpy(), scatter_add_plain(torch.from_numpy(idx),
                                       torch.from_numpy(vals), t).numpy())
    for want in (scatter_add_reference(jnp.asarray(idx), jnp.asarray(vals), t),
                 pallas_scatter_add(jnp.asarray(idx), jnp.asarray(vals), t,
                                    True)):
        _within_f64(np.asarray(want), idx, vals, t)
    _within_f64(got.numpy(), idx, vals, t)


@pytest.mark.parametrize("bad", [0, -8, 8.0, True, None])
def test_scatter_add_rejects_bad_period(bad):
    with pytest.raises((TypeError, ValueError)):
        scatter_add(torch.zeros(8, dtype=torch.int32), torch.zeros(8, 2), 16,
                    bad)


@pytest.mark.parametrize("shape,period", [
    ((64, 16, 8), 128), ((64, 14, 8), 112), ((64, 1, 8), 8),
    ((512, 8), 1), ((64, 4, 2), 1),
    ((64, 3, 32), 96), ((64, 1, 32), 32), ((64, 3, 16), 1)])
def test_table_grad_lookup_backward_passes_layout_period(monkeypatch, shape,
                                                         period):
    """The backward hands K1 the row stride of the encodes' [N, L, 8]
    corner and [N, L, 32] probe-neighbourhood layouts, and 1 for any
    other shape (checked with a spy)."""
    calls = []

    def spy(idx, vals, table_size, period=1):
        calls.append(period)
        return scatter_add(idx, vals, table_size, period)

    monkeypatch.setattr(port_scatter, "scatter_add", spy)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((300, 2)).astype(
        np.float32)).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, 300, shape).astype(np.int32))
    TableGradLookup.apply(table, idx).sum().backward()
    assert calls == [period]
    want = np.zeros((300, 2), np.float32)
    np.add.at(want, idx.numpy().reshape(-1), 1.0)
    np.testing.assert_array_equal(table.grad.numpy(), want)


def test_table_grad_lookup_forward_backward_match_jax():
    rng = np.random.default_rng(2)
    t = 2048
    table = rng.standard_normal((t, 2)).astype(np.float32)
    flat = rng.integers(0, t, size=(512, 8), dtype=np.int32)
    cot = rng.standard_normal((512, 8, 2)).astype(np.float32)

    import jax

    def loss_jax(tb):
        return jnp.sum(table_grad_lookup(tb, jnp.asarray(flat), True)
                       * jnp.asarray(cot))

    want_val, want_grad = jax.value_and_grad(loss_jax)(jnp.asarray(table))

    tb = torch.from_numpy(table).requires_grad_(True)
    out = TableGradLookup.apply(tb, torch.from_numpy(flat))
    np.testing.assert_array_equal(out.detach().numpy(), table[flat])
    loss = torch.sum(out * torch.from_numpy(cot))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_val),
                               rtol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-5)
