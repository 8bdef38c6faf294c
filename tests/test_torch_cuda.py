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
from test_torch_streams import (dense17_rows, probe_encode_rows,
                                ray_encode_rows)

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


@pytest.mark.parametrize("stream,period,cut", [
    ("all_equal", 1, 0),         # one row: a single run down every column
    ("all_equal", 128, 0),
    ("dense17", 8, 0),           # 17^3 dense level, P = 8
    ("dense17", 8, 5),           # P does not divide M: a ragged last row
    ("dense17", 1, 3),           # P = 1, M % 32 = 5: the last entries
    ("rays", 128, 0),            # [N, 16, 8] encode rows, short last walk
    ("rays", 1, 0),
    ("rays", 128, 77),           # P does not divide M
], ids=["equal_p1", "equal_p128", "dense17_p8", "dense17_p8_ragged",
        "dense17_p1_tail", "rays_p128", "rays_p1", "rays_p128_ragged"])
def test_scatter_add_kernel_on_contended_streams(cuda, stream, period, cut):
    """K1's run combining on streams whose neighbouring entries name the
    same row, held to the float64 reference per entry."""
    if stream == "all_equal":
        idx, t = torch.full((100003,), 7, dtype=torch.int32), 64
    elif stream == "dense17":
        rows, t = dense17_rows(1001)
        idx = rows.reshape(-1)
    else:
        rows, t = ray_encode_rows(8, 125)  # 1000 samples: a short last walk
        idx = rows.reshape(-1)
    idx = idx[:idx.numel() - cut].contiguous().to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(period + cut)
    vals = torch.randn((idx.numel(), 2), generator=gen, device=cuda)
    before = scatter_add.launches
    got = scatter_add(idx, vals, t, period)
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    _assert_matches_f64(got, idx, vals, t)


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
    (4096, 2, 4 * 8192 + 3, torch.float32),  # 8 8-byte rows/thread + tail
    (4096, 2, 2, torch.float32),             # the tail alone
    (4096, 2, 2048 * 37 + 2047, torch.float32),  # tiles + a long tail
    (3000, 8, 20000, torch.float32),         # 2 x 16-byte vectors per row
    (3000, 32, 7000, torch.float32),         # 8 x 16-byte vectors per row
    (3000, 2, 5000, torch.float64),          # 1 x 16-byte vector per row
    (3000, 8, 5000, torch.float64),          # 4 x 16-byte vectors per row
], ids=["w2", "w2_tail", "w2_long_tail", "w8", "w32", "f64_w2", "f64_w8"])
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


@pytest.mark.parametrize("tail", range(1, 8))
def test_gather_rows_kernel_every_8_row_tail(cuda, tail):
    """Every remainder of M modulo 8 rows on the 8-byte path."""
    gen = torch.Generator(device=cuda).manual_seed(tail)
    table = torch.randn((5000, 2), generator=gen, device=cuda)
    idx = torch.randint(0, 5000, (2048 * 5 + 8 * 3 + tail,), generator=gen,
                        device=cuda, dtype=torch.int32)
    got = gather_rows(table, idx)
    want = table.index_select(0, idx.long())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gather_rows_kernel_on_encode_rows(cuda):
    """G1 on ray-ordered [N, 16, 8] rows of the port's encode, the layout
    whose neighbouring threads read x-neighbour corners."""
    rows, t = ray_encode_rows(8, 125, seed=1)
    gen = torch.Generator(device=cuda).manual_seed(3)
    table = torch.randn((t, 2), generator=gen, device=cuda)
    idx = rows.reshape(-1).to(cuda)
    got = gather_rows(table, idx)
    want = table.index_select(0, idx.long())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("cut", [0, 50], ids=["whole", "ragged"])
def test_scatter_add_kernel_on_probe_rows_at_period_96(cuda, cut):
    """K1 on the shared-probe encode's [N, 3, 32] rows (the hybrid-FD
    fine band) with their layout's period 96, held to the float64
    reference per entry; and the lookup's backward passes that period
    and launches K1 once."""
    rows, t = probe_encode_rows(4, 250)
    idx = rows.reshape(-1)[:rows.numel() - cut].contiguous().to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(7 + cut)
    vals = torch.randn((idx.numel(), 2), generator=gen, device=cuda)
    before = scatter_add.launches
    got = scatter_add(idx, vals, t, 96)
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    _assert_matches_f64(got, idx, vals, t)
    if cut:
        return
    table = torch.randn((t, 2), generator=gen,
                        device=cuda).requires_grad_(True)
    cot = vals.view(*rows.shape, 2)
    before = scatter_add.launches
    (TableGradLookup.apply(table, rows.to(cuda)) * cot).sum().backward()
    torch.cuda.synchronize()
    assert scatter_add.launches == before + 1
    _assert_matches_f64(table.grad, idx, vals, t)


def test_hybrid_fd_geometry_launches_kernels(cuda):
    """The flagship's FD geometry on the card: the coarse Jacobian
    encode, the shared-probe encode and the curvature probe's fine
    encode each gather through G1, and the backward of a loss on the
    gradient and the curvature takes each table gradient through K1:
    three launches each, no plain path."""
    from rise_sdf_tpu_torch import models
    from rise_sdf_tpu_torch.presets import tiny_split_config

    cfg = tiny_split_config()["model"]["geometry"]
    geo = models.make(cfg["name"], cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # off the sphere init, which reads xyz only
        for p in geo.mlp.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    geo.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.rand((4096, 3), generator=gen, device=cuda) * 2.4 - 1.2
    dirs = torch.rand((4096, 3), generator=gen, device=cuda)
    g1, k1 = gather_rows.launches, scatter_add.launches
    out = geo(x, 30, with_laplace=True, laplace_dirs=dirs, levels=4,
              create_graph=True)
    assert gather_rows.launches == g1 + 3
    gn = torch.sqrt(torch.sum(out["grad"] ** 2, -1) + 1e-12)
    (torch.mean((gn - 1.0) ** 2) + torch.mean(out["laplace"])).backward()
    torch.cuda.synchronize()
    assert scatter_add.launches == k1 + 3
    table = geo.encoding.encoding.table
    assert bool(torch.isfinite(table.grad).all())
    assert bool((table.grad != 0).any())


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


def _raises_in_subprocess(call):
    """Runs ``call`` on an index past a 64-row table's last row in a
    process of its own (a failed context cannot be used again) and
    checks that the launch's stream fails."""
    code = (
        "import torch\n"
        "idx = torch.tensor([0, 5, 64, 1] * 4, dtype=torch.int32, "
        "device='cuda')\n"
        "try:\n"
        + "".join("    " + line + "\n" for line in call.splitlines())
        + "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', str(e).splitlines()[0])\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=600)
    assert "raised:" in res.stdout, (res.stdout, res.stderr)


def test_gather_rows_out_of_range_index_raises(cuda):
    """G1's device-side bound check."""
    _raises_in_subprocess(
        "from rise_sdf_tpu_torch.ops.gather import gather_rows\n"
        "gather_rows(torch.zeros((64, 2), device='cuda'), idx)")


def test_scatter_add_out_of_range_index_raises(cuda):
    """K1's device-side bound check, on its column walk (P = 8)."""
    _raises_in_subprocess(
        "from rise_sdf_tpu_torch.ops.scatter import scatter_add\n"
        "scatter_add(idx, torch.zeros((idx.numel(), 2), device='cuda'), "
        "64, 8)")


def test_forward_multi_on_the_card_matches_cpu(cuda):
    """The tiny split eval through ``forward_multi`` (the learned light
    and a relight light with the third bounce) on the card: G1 gathers
    every encode, no table gradient reaches K1 (the third bounce's
    normal is a gradient with respect to the positions only), and the
    result matches the CPU's plain gathers in float64."""
    import copy

    from rise_sdf_tpu_torch import models
    from rise_sdf_tpu_torch.presets import tiny_split_config

    cfg = tiny_split_config()["model"]
    cfg["variance"]["init_val"] = 0.7
    cfg.update({"num_samples_per_ray": 256, "visibility_prefilter": True,
                "eval_sdf_bake": "full", "eval_sdf_bake_cells": 64})
    model = models.make(cfg["name"], cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    b = torch.linspace(-0.45, 0.45, 32, dtype=torch.float64)
    d = torch.stack([torch.zeros_like(b), b / 4.0, torch.ones_like(b)], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    rays = torch.cat([torch.tensor([[0.0, 0.0, -4.0]],
                                   dtype=torch.float64).expand(32, 3), d], -1)
    outs = {}
    for dev in ("cpu", cuda):
        m = copy.deepcopy(model).double().to(dev).requires_grad_(False)
        mips = [m.emitter.build_mips(),
                m.emitter.build_mips(torch.roll(m.emitter.base * 1.7, 1, -1))]
        g1, k1 = gather_rows.launches, scatter_add.launches
        outs[str(dev)] = m.forward_multi(
            rays.to(dev), occ_binary=torch.ones(
                m.grid_resolution ** 3, dtype=torch.bool, device=dev),
            mips_list=mips, relight_flags=(False, True), step=20, stage=1,
            capacity=768, background_color=torch.ones(
                3, dtype=torch.float64, device=dev),
            prefilter=True, banded=True, bake=m.bake_eval_sdf(20))
        torch.cuda.synchronize()
    assert gather_rows.launches > g1 and scatter_add.launches == k1
    for cpu, gpu in zip(outs["cpu"], outs[str(cuda)]):
        for k in ("comp_rgb_full", "opacity", "comp_rgb_phys_full"):
            assert float((gpu[k].cpu() - cpu[k]).abs().max()) <= 1e-9, k
        assert torch.equal(gpu["ray_included"].cpu(), cpu["ray_included"])


def test_deterministic_eval_ops_repeat_bit_for_bit(cuda):
    """``blocked_cumsum`` and ``sorted_segment_sum`` on a 1,048,576-slot
    ray-major buffer of 4096 rays: every call gives the same bits; the
    scan is within 1e-6 of the float64 scan's largest magnitude (a
    float32 scan's rounding), each sum within one float32 ulp of the
    float64 sum."""
    from rise_sdf_tpu_torch.ops import volrend

    gen = torch.Generator(device=cuda).manual_seed(0)
    n_rays, c = 4096, 1 << 20
    counts = torch.randint(0, 2 * c // n_rays, (n_rays,), generator=gen,
                           device=cuda)
    ridx = torch.repeat_interleave(torch.arange(n_rays, device=cuda),
                                   counts)[:c]
    ridx = torch.cat([ridx, torch.full((c - ridx.shape[0],), n_rays,
                                       device=cuda)])
    la = torch.log1p(-torch.rand(c, generator=gen, device=cuda) * 0.1)
    src = torch.rand((c, 9), generator=gen, device=cuda)
    scans = [volrend.blocked_cumsum(la) for _ in range(4)]
    sums = [volrend.sorted_segment_sum(src, ridx, n_rays) for _ in range(4)]
    assert all(torch.equal(s, scans[0]) for s in scans)
    assert all(torch.equal(s, sums[0]) for s in sums)
    ref = torch.cumsum(la.double(), 0)
    assert float((scans[0].double() - ref).abs().max()) \
        <= 1e-6 * float(ref.abs().max())
    want = torch.zeros((n_rays + 1, 9), dtype=torch.float64,
                       device=cuda).index_add(0, ridx, src.double())[:n_rays]
    # the float64 difference, rounded once to float32: within one ulp
    err = (sums[0].double() - want).abs()
    assert bool((err <= 1.2e-7 * want.abs() + 1e-9).all())
