"""Kernel K2 (the deterministic scatter-add) and the deterministic
training path on the card (marker ``cuda``; skipped without a CUDA
device).

Imports only torch and the port, so it also runs where jax is absent:
``python -m pytest --noconftest tests/test_torch_cuda_sorted.py`` on a
machine with the GPU."""

import os

import numpy as np
import pytest
import torch

from rise_sdf_tpu_torch import datasets, presets, systems
from rise_sdf_tpu_torch.ops import scatter
from rise_sdf_tpu_torch.ops.scatter_sorted import (
    index_select, scatter_add_sorted, scatter_add_sorted_plain)
from test_torch_streams import probe_encode_rows, ray_encode_rows

pytestmark = pytest.mark.cuda
# cuBLAS's workspace setting that torch's deterministic mode asks for
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _same_bits(a, b):
    """Equal bit for bit, NaNs compared by place (their payloads are the
    kernel's and the plain version's own constants)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(
        torch.equal(a[~nan], b[~nan]))


def _check(idx, vals, t, period=1):
    """K2 twice: bit-equal to each other and to its plain version, one
    launch each, and per entry within 1e-6 of a float64 sum (float32: K2
    rounds its exact sum once) or within 1e-13 of the sum of the
    magnitudes (float64, added in another order)."""
    before = scatter_add_sorted.launches
    a = scatter_add_sorted(idx, vals, t, period)
    b = scatter_add_sorted(idx, vals, t, period)
    torch.cuda.synchronize()
    assert scatter_add_sorted.launches == before + 2
    assert torch.equal(a, b)
    assert torch.equal(a, scatter_add_sorted_plain(idx, vals, t))
    ref = torch.zeros((t, vals.shape[1]), dtype=torch.float64,
                      device=vals.device).index_add_(0, idx.long(),
                                                     vals.double())
    err = (a.double() - ref).abs()
    if vals.dtype == torch.float32:
        assert bool((err <= 1e-6 * ref.abs()).all())
    else:
        mag = torch.zeros_like(ref).index_add_(0, idx.long(), vals.abs())
        assert bool((err <= 1e-13 * mag).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("f", [1, 2, 3, 13])
@pytest.mark.parametrize("m,t", [(1, 3), (33, 2), (40000, 3000),
                                 (1 << 20, 5)])
def test_sorted_scatter_matches_float64_and_repeats(cuda, m, t, f, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + f)
    idx = torch.randint(0, t, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    vals = torch.randn((m, f), generator=gen, device=cuda, dtype=dtype)
    _check(idx, vals, t)


@pytest.mark.parametrize("stream", ["corners", "probes"])
def test_sorted_scatter_on_encode_rows(cuda, stream):
    rows, t = ray_encode_rows(64, 250) if stream == "corners" \
        else probe_encode_rows(16, 500)
    idx = rows.reshape(-1).to(cuda)
    vals = torch.randn((idx.shape[0], 2), device=cuda)
    _check(idx, vals, t)
    _check(idx, vals, t, rows.shape[-2] * rows.shape[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sorted_scatter_non_finite_rows(cuda, dtype):
    """NaN, +Inf, -Inf and both infinities, alone and among finite
    values, in float32 and float64: the kernel bit-equal to its plain
    version and to what a float sum gives, across launches."""
    inf, nan = float("inf"), float("nan")
    idx = torch.tensor([0, 0, 1, 1, 2, 3, 3, 4, 5, 5, 6], dtype=torch.int32,
                       device=cuda).repeat(40)
    col = torch.tensor([1.5, nan, inf, 2.0, -inf, inf, -inf, 0.25, -inf,
                        -inf, 3.0], dtype=dtype, device=cuda).repeat(40)
    vals = torch.stack([col, col.flip(0)], 1).contiguous()
    a = scatter_add_sorted(idx, vals, 8, 11)
    b = scatter_add_sorted(idx, vals, 8, 11)
    torch.cuda.synchronize()
    assert _same_bits(a, b)
    assert _same_bits(a, scatter_add_sorted_plain(idx, vals, 8))
    want = torch.zeros((8, 2), dtype=torch.float64,
                       device=cuda).index_add_(0, idx.long(),
                                               vals.double()).to(dtype)
    assert torch.equal(torch.isnan(a), torch.isnan(want))
    assert torch.equal(a[~torch.isnan(a)], want[~torch.isnan(want)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sorted_scatter_wide_range(cuda, dtype):
    """Values over 120 binades, as a cotangent far from convergence has
    them: each entry takes its own scale, so every entry, however far
    below the largest, stays within 1e-6 of its magnitudes of a float64
    sum, and the kernel is bit-equal to its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    idx = torch.randint(0, 5000, (400000,), generator=gen, device=cuda,
                        dtype=torch.int32)
    spread = torch.exp2(-(idx.double() % 120) + 40)[:, None]
    vals = (torch.randn((400000, 2), generator=gen, device=cuda,
                        dtype=torch.float64) * spread).to(dtype)
    _check(idx, vals, 5000, 8)
    ref = torch.zeros((5000, 2), dtype=torch.float64,
                      device=cuda).index_add_(0, idx.long(), vals.double())
    mag = torch.zeros_like(ref).index_add_(0, idx.long(),
                                           vals.double().abs())
    got = scatter_add_sorted(idx, vals, 5000, 8).double()
    assert bool(((got - ref).abs() <= 1e-6 * mag).all())


@pytest.mark.parametrize("value", [2.0 ** -120, 3.0e38, 2.0 ** -1074],
                         ids=["tiny", "largest_f32", "f64_subnormal"])
def test_sorted_scatter_extreme_magnitudes(cuda, value):
    """The scale at the ends of the range: the kernel bit-equal to its
    plain version, and a lone value comes back exactly."""
    for dtype in (torch.float32, torch.float64):
        v = torch.tensor(value, dtype=dtype)
        if v.item() == 0.0:
            continue  # below float32's range
        idx = torch.tensor([3, 3, 1, 3], dtype=torch.int32, device=cuda)
        vals = torch.tensor([[0.0], [v.item()], [-v.item()], [0.0]],
                            dtype=dtype, device=cuda)
        a = scatter_add_sorted(idx, vals, 5)
        torch.cuda.synchronize()
        assert torch.equal(a, scatter_add_sorted_plain(idx, vals, 5))
        assert a[3, 0].item() == v.item() and a[1, 0].item() == -v.item()


def test_sorted_lookup_launches_k2_not_k1(cuda):
    table = torch.randn((4096, 2), device=cuda, requires_grad=True)
    rows, _ = ray_encode_rows(8, 125)
    idx = (rows.reshape(-1) % 4096).to(cuda)
    k1, k2 = scatter.scatter_add.launches, scatter_add_sorted.launches
    scatter.table_grad_lookup(table, idx, "sorted").sum().backward()
    torch.cuda.synchronize()
    assert scatter_add_sorted.launches == k2 + 1
    assert scatter.scatter_add.launches == k1


def test_gather_backward_on_the_card(cuda, deterministic):
    x = torch.randn((5000, 3), device=cuda, dtype=torch.float64,
                    requires_grad=True)
    idx = torch.randint(0, 5000, (100000,), device=cuda)
    g = torch.randn((100000, 3), device=cuda, dtype=torch.float64)
    grads = []
    for _ in range(2):
        x.grad = None
        (index_select(x, idx) * g).sum().backward()
        grads.append(x.grad.clone())
    assert torch.equal(grads[0], grads[1])
    want = torch.zeros_like(x).index_add_(0, idx, g)
    torch.testing.assert_close(grads[0], want, rtol=1e-12, atol=1e-12)


def test_deterministic_tiny_fits_repeat_bit_for_bit(cuda, deterministic,
                                                     tmp_path):
    """Two 6-step NeuS fits at ``tiny_neus_config`` from one seed: equal
    parameters and Adam moments, K2 and not K1."""
    cfg = presets.tiny_neus_config()
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=str(tmp_path / "save"),
                          ckpt_dir=str(tmp_path / "ckpt"), device="cuda")
    runs = []
    k1, k2 = scatter.scatter_add.launches, scatter_add_sorted.launches
    for _ in range(2):
        state = system.fit(max_steps=6, seed=3, state=system.init_state(3),
                           log_every=0)
        snap = [p.detach().clone() for p in system.model.parameters()]
        snap += [system.optimizer.state[p][k].clone()
                 for p in system.model.parameters()
                 for k in ("exp_avg", "exp_avg_sq")]
        runs.append(snap + [state["occs"].clone()])
    assert scatter.scatter_add.launches == k1
    assert scatter_add_sorted.launches > k2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert np.isfinite(float(runs[0][0].abs().sum()))
