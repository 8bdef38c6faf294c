"""Kernels K1 (scatter-add) and G1 (row gather) on the card (marker
``cuda``; skipped without a CUDA device).

Imports only torch and the port, so it also runs where jax is absent:
``python -m pytest --noconftest tests/test_torch_cuda.py`` on a machine
with the GPU (the repo's conftest imports jax)."""

import os
import subprocess
import sys

import pytest
import torch

from rise_sdf_tpu_torch.ops.gather import gather_rows
from rise_sdf_tpu_torch.ops.scatter import (
    TableGradLookup,
    scatter_add,
    scatter_add_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_matches_f64(got, idx, vals, t):
    """Per entry |got - ref64| <= 1e-5 * sum|v| + 1e-7 (float32 atomics
    add in another order)."""
    want = torch.zeros((t, vals.shape[1]), dtype=torch.float64,
                       device=vals.device).index_add_(0, idx.long(),
                                                      vals.double())
    s = torch.zeros_like(want).index_add_(0, idx.long(), vals.double().abs())
    assert bool(((got.double() - want).abs() <= 1e-5 * s + 1e-7).all())


@pytest.mark.parametrize("m,t,f,offset", [
    (3 * 8192 + 100, 4096, 2, 0),   # float2 vector atomics
    (8192, 35937, 2, 0),
    (5000, 300, 3, 0),              # scalar path: F != 2
    (5000, 300, 2, 1),              # scalar path: rows not 8-byte aligned
], ids=["f2", "f2_odd_table", "f3", "f2_misaligned"])
def test_scatter_add_kernel_matches_reference(cuda, m, t, f, offset):
    gen = torch.Generator(device=cuda).manual_seed(m + f + offset)
    idx = torch.randint(0, t, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    vals = torch.randn(m * f + offset, generator=gen,
                       device=cuda)[offset:].view(m, f)
    before = scatter_add.launches
    got = scatter_add(idx, vals, t)
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    _assert_matches_f64(got, idx, vals, t)
    torch.testing.assert_close(got, scatter_add_plain(idx, vals, t),
                               rtol=1e-5, atol=1e-5)


def test_table_grad_lookup_backward_launches_kernel(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((2048, 2), generator=gen,
                        device=cuda).requires_grad_(True)
    idx = torch.randint(0, 2048, (512, 8), generator=gen, device=cuda,
                        dtype=torch.int32)
    cot = torch.randn((512, 8, 2), generator=gen, device=cuda)
    before = scatter_add.launches
    (TableGradLookup.apply(table, idx) * cot).sum().backward()
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    _assert_matches_f64(table.grad, idx.reshape(-1), cot.reshape(-1, 2),
                        2048)


def test_scatter_add_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        scatter_add(torch.zeros(4, dtype=torch.int32),
                    torch.zeros((4, 2), device=cuda), 8)


@pytest.mark.parametrize("n,w,m,dtype", [
    (4096, 2, 4 * 8192 + 3, torch.float32),  # 4 8-byte rows/thread + tail
    (4096, 2, 2, torch.float32),             # the tail alone
    (3000, 8, 20000, torch.float32),         # 2 x 16-byte vectors per row
    (3000, 32, 7000, torch.float32),         # 8 x 16-byte vectors per row
    (3000, 2, 5000, torch.float64),          # 1 x 16-byte vector per row
    (3000, 8, 5000, torch.float64),          # 4 x 16-byte vectors per row
], ids=["w2", "w2_tail", "w8", "w32", "f64_w2", "f64_w8"])
def test_gather_rows_kernel_is_bit_equal(cuda, n, w, m, dtype):
    """A gather copies bits: G1 equals ``index_select`` exactly."""
    gen = torch.Generator(device=cuda).manual_seed(n + w + m)
    table = torch.randn((n, w), generator=gen, device=cuda, dtype=dtype)
    idx = torch.randint(0, n, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    before = gather_rows.launches
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    want = table.index_select(0, idx.long())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_table_grad_lookup_forward_launches_gather(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn((2048, 2), generator=gen, device=cuda)
    idx = torch.randint(0, 2048, (512, 8), generator=gen, device=cuda,
                        dtype=torch.int32)
    before = gather_rows.launches
    got = TableGradLookup.apply(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, table[idx.long()])


def test_gather_rows_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        gather_rows(torch.zeros((4, 2), device=cuda),
                    torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["12_byte_rows", "misaligned_idx"])
def test_gather_rows_rejects_rows_g1_does_not_take(cuda, bad):
    table = torch.zeros((8, 3 if bad == "12_byte_rows" else 2), device=cuda)
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    before = gather_rows.launches
    with pytest.raises(ValueError):
        gather_rows(table, idx if bad == "12_byte_rows" else idx[1:])
    assert gather_rows.launches == before


def test_gather_rows_out_of_range_index_raises(cuda):
    """G1's device-side bound check: an index past the table's last row
    fails the launch's stream.  The failed context cannot be used again,
    so the gather runs in a process of its own."""
    code = (
        "import torch\n"
        "from rise_sdf_tpu_torch.ops.gather import gather_rows\n"
        "table = torch.zeros((64, 2), device='cuda')\n"
        "idx = torch.tensor([0, 5, 64, 1], dtype=torch.int32, "
        "device='cuda')\n"
        "try:\n"
        "    gather_rows(table, idx)\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', str(e).splitlines()[0])\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=600)
    assert "raised:" in res.stdout, (res.stdout, res.stderr)
