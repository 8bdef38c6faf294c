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


# rows of q 16-byte vectors: (table width, dtype) per q
ROWS16 = {(1, torch.float32): 4, (1, torch.float64): 2,
          (2, torch.float32): 8, (2, torch.float64): 4,
          (8, torch.float32): 32, (8, torch.float64): 16,
          (3, torch.float32): 12}  # q = 3: the general case, a division
ROWS16_IDS = [f"q{q}_{str(dt)[6:]}" for q, dt in ROWS16]


def _tile_vecs(q):
    """Output vectors in one warp tile of the 16-byte path."""
    return 32 if q == 1 else 64


def _bit_equal_to_index_select(table, idx):
    got = gather_rows(table, idx)
    torch.cuda.synchronize()
    want = table[idx.long().clamp(min=0)].masked_fill(
        (idx < 0)[:, None], 0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("q,dtype", list(ROWS16), ids=ROWS16_IDS)
def test_gather_rows16_kernel_is_bit_equal(cuda, q, dtype):
    """G1's 16-byte path at q vectors a row, over many blocks of warp
    tiles: bit-equal to ``index_select``, one launch on each count."""
    w = ROWS16[q, dtype]
    gen = torch.Generator(device=cuda).manual_seed(q + w)
    table = torch.randn((5000, w), generator=gen, device=cuda, dtype=dtype)
    idx = torch.randint(0, 5000, (100003,), generator=gen, device=cuda,
                        dtype=torch.int32)
    before = gather_rows.launches, gather_rows.launches16
    _bit_equal_to_index_select(table, idx)
    assert (gather_rows.launches, gather_rows.launches16) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("q,dtype", [k for k in ROWS16
                                     if k[1] == torch.float32],
                         ids=[i for i, k in zip(ROWS16_IDS, ROWS16)
                              if k[1] == torch.float32])
def test_gather_rows16_kernel_every_tile_tail(cuda, q, dtype):
    """Every length of the last, partial warp tile (a tile is 32 vectors
    for q = 1, else 64: 64 / q rows), after 17 whole tiles (more than two
    blocks of 8 warps) and alone."""
    w = ROWS16[q, dtype]
    gen = torch.Generator(device=cuda).manual_seed(40 + q)
    table = torch.randn((3000, w), generator=gen, device=cuda)
    tile = _tile_vecs(q)
    idx = torch.randint(0, 3000, (18 * tile,), generator=gen,
                        device=cuda, dtype=torch.int32)
    tile_rows = tile // q
    tails = range(1, tile_rows) if tile % q == 0 else range(1, tile + 1)
    for whole in (0, 17):
        for tail in tails:
            _bit_equal_to_index_select(table, idx[:whole * tile_rows + tail])


@pytest.mark.parametrize("q,dtype", list(ROWS16), ids=ROWS16_IDS)
def test_gather_rows16_kernel_absent_rows_are_zeros(cuda, q, dtype):
    """A negative index (another shard's row) gives a row of zeros; its
    table row is never read (NaN there reaches nothing)."""
    w = ROWS16[q, dtype]
    gen = torch.Generator(device=cuda).manual_seed(60 + q)
    table = torch.randn((4000, w), generator=gen, device=cuda, dtype=dtype)
    idx = torch.randint(1, 4000, (20000 + q,), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[torch.rand(idx.shape, generator=gen, device=cuda) < 0.3] = -1
    idx[:_tile_vecs(q)] = -1  # a whole tile (or more) absent
    table[0] = float("nan")  # no index names row 0
    _bit_equal_to_index_select(table, idx)


def test_gather_rows16_out_of_range_index_raises(cuda):
    """G1's device-side bound check on its 16-byte path (32-byte
    rows)."""
    _raises_in_subprocess(
        "from rise_sdf_tpu_torch.ops.gather import gather_rows\n"
        "gather_rows(torch.zeros((64, 8), device='cuda'), idx)")


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


@pytest.mark.parametrize("f,period", [(2, 128), (2, 1), (3, 8)],
                         ids=["walk", "no_layout", "scalar"])
def test_kernels_take_absent_rows(cuda, f, period):
    """A negative index (another shard's row): G1 writes zeros, K1 and K2
    drop it, runs of equal rows around it included; the kernels equal
    their plain versions (K1 within its float32 bound, G1 and K2 bit for
    bit)."""
    from rise_sdf_tpu_torch.ops import scatter_sorted

    gen = torch.Generator(device=cuda).manual_seed(16 + f + period)
    m, t = 8192 * 8, 3000
    idx = torch.randint(0, t, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    # runs of equal rows, broken by absent ones
    idx = idx.view(-1, 8).sort(0).values.reshape(-1).contiguous()
    absent = torch.rand(m, generator=gen, device=cuda) < 0.3
    idx = torch.where(absent, -1, idx).to(torch.int32)
    vals = torch.randn((m, f), generator=gen, device=cuda)
    vals[absent] = float("nan")  # reaches nothing
    keep = idx >= 0
    got = scatter_add(idx, vals, t, period)
    torch.cuda.synchronize()
    _assert_matches_f64(got, idx[keep], vals[keep], t)
    k2 = scatter_sorted.scatter_add_sorted(idx, vals, t, period)
    assert torch.equal(k2, scatter_sorted.scatter_add_sorted_plain(
        idx, vals, t))
    for w in (2, 8):
        table = torch.randn((t, w), generator=gen, device=cuda)
        rows = gather_rows(table, idx)
        assert torch.equal(rows, table[idx.long().clamp(min=0)]
                           .masked_fill(~keep[:, None], 0))


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


def test_eval_scan_does_not_depend_on_where_a_ray_sits(cuda):
    """The eval scan (``render_weight_from_alpha(deterministic=True)``) on
    a 1,048,576-slot buffer of 4096 rays (its running total reaches
    about -1.6e5, where a float32 sum rounds at 2^-6): the last 64 rays'
    transmittance and weights there and in a buffer of their own agree
    to 1e-6, and both are within 1e-6 of a float64 scan of each ray."""
    from rise_sdf_tpu_torch.ops import volrend

    gen = torch.Generator(device=cuda).manual_seed(1)
    n_rays, c, tail = 4096, 1 << 20, 64
    counts = torch.randint(1, c // n_rays, (n_rays,), generator=gen,
                           device=cuda)
    ridx = torch.repeat_interleave(torch.arange(n_rays, device=cuda), counts)
    ridx = torch.cat([ridx, torch.full((c - ridx.shape[0],), n_rays,
                                       device=cuda)])
    alphas = torch.rand(c, generator=gen, device=cuda) * 0.5
    starts = torch.searchsorted(ridx, torch.arange(n_rays + 1, device=cuda))
    whole = volrend.render_weight_from_alpha(
        alphas, starts[:-1], ridx, ridx < n_rays, n_rays, deterministic=True)
    lo, hi = int(starts[-tail - 1]), int(starts[-1])
    sub_idx = ridx[lo:hi] - (n_rays - tail)
    alone = volrend.render_weight_from_alpha(
        alphas[lo:hi], starts[-tail - 1:-1] - lo, sub_idx,
        torch.ones_like(sub_idx, dtype=torch.bool), tail, deterministic=True)
    la = torch.log1p(-torch.clamp(alphas[lo:hi].double(), 0.0, 1.0 - 1e-7))
    c64 = torch.cumsum(la, 0) - la
    trans64 = torch.exp(c64 - c64[starts[-tail - 1:-1] - lo][sub_idx])
    want = (trans64 * alphas[lo:hi].double(), trans64)
    for w, a, ref in zip(whole, alone, want):
        assert float((w[lo:hi] - a).abs().max()) <= 1e-6
        assert float((a.double() - ref).abs().max()) <= 1e-6
        assert float((w[lo:hi].double() - ref).abs().max()) <= 1e-6


def test_two_gloo_ranks_share_the_card_with_equal_params(cuda):
    """Two gloo ranks on ``cuda:0`` take one tiny split stage-1 step
    (``dryrun_multichip``): K1 and G1 on every rank, the all-reduced
    gradients the mean of the ranks' own, the params bit-equal."""
    from rise_sdf_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(2, "cuda", "gloo")
    a, b = res["ranks"]
    for k, post in a["post"].items():
        assert torch.equal(post, (a["pre"][k] + b["pre"][k]) / 2), k
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert any(not torch.equal(a["pre"][k], b["pre"][k]) for k in a["pre"])


@pytest.fixture
def second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 1)


def test_kernels_on_the_second_card(second_card):
    gen = torch.Generator(device=second_card).manual_seed(5)
    idx = torch.randint(0, 4096, (3 * 8192 + 100,), generator=gen,
                        device=second_card, dtype=torch.int32)
    vals = torch.randn((idx.numel(), 2), generator=gen, device=second_card)
    got = scatter_add(idx, vals, 4096)
    torch.cuda.synchronize(second_card)
    assert got.device == second_card
    _assert_matches_f64(got, idx, vals, 4096)
    table = torch.randn((4096, 2), generator=gen, device=second_card)
    got = gather_rows(table, idx)
    torch.cuda.synchronize(second_card)
    assert torch.equal(got, table.index_select(0, idx.long()))


def test_learned_background_launches_kernels_and_matches_cpu(cuda):
    """The tiny NeuS model with a learned background on the card: one
    training forward gathers through G1 twice (the foreground's and the
    background's encodes) and its backward takes both table gradients
    through K1; the loss and both tables' gradients agree with the CPU's
    (plain gather and scatter) to 1e-4 of their largest entry."""
    import copy

    from rise_sdf_tpu_torch import models
    from rise_sdf_tpu_torch.presets import tiny_neus_colmap_config

    cfg = tiny_neus_colmap_config()["model"]
    cpu = models.make(cfg["name"], cfg)
    gen = torch.Generator().manual_seed(0)
    cpu.reset_parameters(gen)
    with torch.no_grad():  # off the sphere init, which reads xyz only
        for p in cpu.geometry.mlp.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    card = copy.deepcopy(cpu).to(cuda)
    gen = torch.Generator().manual_seed(1)
    o = torch.randn((256, 3), generator=gen)
    o = 3.0 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 3.0 + 0.5 * torch.randn((256, 3), generator=gen)
    rays = torch.cat([o, d / d.norm(dim=-1, keepdim=True)], -1)
    grads = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = next(model.parameters()).device
        g1, k1 = gather_rows.launches, scatter_add.launches
        out = model(rays.to(dev), occ_binary=None, step=3, train=True,
                    capacity=256 * 64,
                    background_color=torch.full((3,), 0.5, device=dev))
        loss = out["comp_rgb_full"].square().mean() \
            + out["comp_rgb_bg"].mean()
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert gather_rows.launches == g1 + 2
            assert scatter_add.launches == k1 + 2
        grads[name] = (loss.detach().cpu(), {
            k: model.get_submodule(k).encoding.encoding.table.grad.cpu()
            for k in ("geometry", "geometry_bg")})
    assert torch.allclose(grads["cuda"][0], grads["cpu"][0], rtol=1e-4)
    for k, want in grads["cpu"][1].items():
        got = grads["cuda"][1][k]
        assert float(want.abs().max()) > 0, k
        assert float((got - want).abs().max()) \
            <= 1e-4 * float(want.abs().max()), k


def test_distortion_loss_on_the_card_matches_float64(cuda):
    from rise_sdf_tpu_torch.ops import volrend

    gen = torch.Generator().manual_seed(2)
    counts = torch.randint(0, 200, (512,), generator=gen)
    n, cap = int(counts.sum()), int(counts.sum()) + 100
    ridx = torch.cat([torch.repeat_interleave(torch.arange(512), counts),
                      torch.full((100,), 512)])
    start = torch.cumsum(counts, 0) - counts
    mids = torch.cat([torch.sort(torch.rand(int(c), generator=gen))[0]
                      for c in counts] + [torch.zeros(100)])
    w = torch.rand(cap, generator=gen) * 0.05
    iv = torch.rand(cap, generator=gen) * 0.01
    valid = torch.arange(cap) < n
    args = (w, mids, iv, ridx, start, valid)
    want = volrend.distortion_loss(*(a.double() if a.is_floating_point()
                                     else a for a in args), 512)
    got = volrend.distortion_loss(*(a.to(cuda) for a in args), 512)
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
