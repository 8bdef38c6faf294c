"""The eval encode E1 (``csrc/hashgrid_eval.cu``) on the card (marker
``cuda``; skipped without a CUDA device), held to the chain it replaces
on the card: the features bit for bit, the position gradient bit for
bit, one launch of each kernel a call and no G1 or K1 launch, over the
configurations of ``tests/test_torch_encode_eval.py`` (ranges from a
level above 0, across the dense/hashed split and past it, a progressive
mask, a grid with none) and at the render's and the bake's shapes; and
which encodes ``VolumeSDF`` sends to E1 on the card.

Imports only torch, the port and the CPU file: ``python -m pytest
--noconftest tests/test_torch_cuda_encode_eval.py`` on a machine with
the GPU."""

import pytest
import torch

from rise_sdf_tpu_torch import trace
from rise_sdf_tpu_torch.ops import hashgrid_eval
from rise_sdf_tpu_torch.ops.gather import gather_rows
from rise_sdf_tpu_torch.ops.hashgrid import HashGridEncoding
from rise_sdf_tpu_torch.ops.scatter import scatter_add
from test_torch_encode_eval import CASES, _encoding, _geometry, _points

pytestmark = pytest.mark.cuda

# the flagship's encoding (configs/split-mixed-occ-tensoir.yaml)
FLAGSHIP = {"otype": "ProgressiveBandHashGrid", "n_levels": 16,
            "start_level": 6, "start_step": 6000, "update_steps": 500,
            "n_features_per_level": 2, "log2_hashmap_size": 19,
            "base_resolution": 32, "per_level_scale": 1.447269237440378}
# the largest gap of E1b's gradient to the chain's, as a share of the
# largest |gradient|: none (bit-equal)
GRAD_GAP = 0.0
# (points, levels, step): the render chunk's buffer at 14 open levels of
# 16; a bake chunk at the render's step (all 16 levels in range, the
# mask closing 14 and 15); a ragged edge of 7 points
SHAPES = {"render": (393_216, 14, None), "bake": (262_144, None, 12_001),
          "ragged": (7, None, 12_001)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(shape, device, seed=0):
    """The flagship encoding with a trained-scale table and points along
    rays (consecutive samples in nearby cells), some on the cube's
    faces, and a cotangent of the features as the MLP's backward hands
    it (a column slice past the 3 xyz columns)."""
    n, levels, step = SHAPES[shape]
    gen = torch.Generator().manual_seed(seed)
    enc = HashGridEncoding(3, FLAGSHIP)
    with torch.no_grad():
        enc.table.copy_(torch.randn(enc.table.shape, generator=gen) * 0.1)
    enc = enc.to(device)
    rays = -(-n // 96)
    o = torch.rand((rays, 1, 3), generator=gen)
    d = torch.nn.functional.normalize(torch.randn((rays, 1, 3),
                                                  generator=gen), dim=-1)
    t = torch.linspace(0.0, 0.4, 96)[None, :, None]
    x = (o + d * t).reshape(-1, 3)[:n].clamp(0.0, 1.0)
    x[: n // 8, 0] = 0.0
    x[n // 8: n // 4, 2] = 1.0
    x[-1] = 1.0
    g = torch.randn((n, 3 + 2 * enc.n_levels), generator=gen)[:, 3:]
    return enc, x.to(device), g.to(device), levels, step


@pytest.mark.parametrize("shape", list(SHAPES))
def test_features_are_bit_equal_to_the_chain(cuda, shape):
    enc, x, _, levels, step = _setup(shape, cuda)
    with torch.no_grad():
        want = enc(x, step, levels=levels)
        launches = (hashgrid_eval.encode_features.launches,
                    gather_rows.launches)
        got = enc(x, step, levels=levels, eval_encode=True)
        torch.cuda.synchronize()
        assert (hashgrid_eval.encode_features.launches - launches[0],
                gather_rows.launches - launches[1]) == (1, 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_position_gradient_matches_the_chain(cuda, shape):
    enc, x, g, levels, step = _setup(shape, cuda)
    xc = x.clone().requires_grad_(True)
    want, = torch.autograd.grad(enc(xc, step, levels=levels), xc, g)
    xe = x.clone().requires_grad_(True)
    feats = enc(xe, step, levels=levels, eval_encode=True)
    before = (hashgrid_eval.encode_position_grad.launches,
              gather_rows.launches, scatter_add.launches)
    got, = torch.autograd.grad(feats, xe, g)
    torch.cuda.synchronize()
    assert (hashgrid_eval.encode_position_grad.launches - before[0],
            gather_rows.launches - before[1],
            scatter_add.launches - before[2]) == (1, 0, 0)
    gap = float((got - want).abs().max())
    assert gap <= GRAD_GAP * float(want.abs().max())
    if GRAD_GAP == 0.0:
        assert torch.equal(got, want)


def _launches():
    return (hashgrid_eval.encode_features.launches,
            hashgrid_eval.encode_position_grad.launches,
            gather_rows.launches, scatter_add.launches)


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_equal_the_chain_over_the_cases(cuda, case):
    """E1f and E1b through ``HashGridEncoding`` on each of the CPU file's
    configurations, with points on every face and corner of the cube,
    against the chain and autograd's gradient through it on the card."""
    cfg, levels, step = CASES[case]
    enc = _encoding(cfg).to(cuda)
    n = 4096
    x = _points(n).to(cuda)
    g = torch.randn((n, 3 + enc.n_output_dims),
                    generator=torch.Generator().manual_seed(2))
    g = g.to(cuda)[:, 3:]
    xc = x.clone().requires_grad_(True)
    want = enc(xc, step, levels=levels)
    want_g, = torch.autograd.grad(want, xc, g)
    xe = x.clone().requires_grad_(True)
    before = _launches()
    got = enc(xe, step, levels=levels, eval_encode=True)
    got_g, = torch.autograd.grad(got, xe, g)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == (1, 1, 0, 0)
    assert torch.equal(got, want.detach())
    gap = float((got_g - want_g).abs().max())
    assert gap <= GRAD_GAP * float(want_g.abs().max())
    if GRAD_GAP == 0.0:
        assert torch.equal(got_g, want_g)


@pytest.mark.parametrize("how", ["no_grad", "grad", "float64", "sharded"])
def test_geometry_dispatch_on_the_card(cuda, how):
    """The analytic forward under ``no_grad`` counts its points in
    ``encode.eval_points`` and launches E1f and E1b once each, with no G1
    or K1; with grad enabled, in float64 and on a row-sharded table it
    takes the chain (a shard without its model group raises; inside
    ``unsharded`` the whole table takes E1)."""
    geo = _geometry().to(cuda)
    x = (torch.rand((300, 3), device=cuda) * 2.0 - 1.0) * geo.radius
    if how == "float64":
        geo, x = geo.double(), x.double()
    if how == "sharded":
        enc = geo.encoding.encoding
        full = enc.table.detach().clone()
        enc.shard_table(2, 0, None)
        with torch.no_grad(), pytest.raises(RuntimeError,
                                            match="without its model group"):
            geo(x, 5, grad_mode="analytic")
    before = _launches()
    with trace.recording() as rec:
        if how == "grad":
            geo(x, 5, grad_mode="analytic")
        elif how == "sharded":
            with torch.no_grad(), enc.unsharded(full):
                geo(x, 5, grad_mode="analytic")
        else:
            with torch.no_grad():
                geo(x, 5, grad_mode="analytic")
    torch.cuda.synchronize()
    e1f, e1b, g1, k1 = (a - b for a, b in zip(_launches(), before))
    if how in ("no_grad", "sharded"):
        assert rec.counts == {"encode.eval_points": [300]}
        assert (e1f, e1b, g1, k1) == (1, 1, 0, 0)
    else:
        assert rec.counts == {"encode.chain_points": [300]}
        assert (e1f, e1b, k1) == (0, 0, 0) and g1 >= 1
    assert geo.encoding.encoding.table.grad is None


def test_eval_geometry_matches_the_chain_on_the_card(cuda):
    """The flagship's geometry at its widths: the analytic forward under
    ``no_grad`` (E1) against the same forward with grad enabled (the
    chain): SDF, features and normals bit for bit."""
    from rise_sdf_tpu_torch import presets
    from rise_sdf_tpu_torch.models.geometry import VolumeSDF

    cfg = dict(presets.split_mixed_occ_full()["model"]["geometry"])
    cfg["xyz_encoding_config"] = dict(cfg["xyz_encoding_config"], **FLAGSHIP)
    torch.manual_seed(0)
    geo = VolumeSDF(cfg).to(cuda)
    with torch.no_grad():
        geo.encoding.encoding.table.normal_(0.0, 0.1)
    x = (torch.rand((65_536, 3), device=cuda) * 2.0 - 1.0) * geo.radius
    want = geo(x, 12_001, grad_mode="analytic", levels=14)
    with torch.no_grad():
        got = geo(x, 12_001, grad_mode="analytic", levels=14)
    for k in ("sdf", "feature", "grad"):
        assert torch.equal(got[k], want[k]), k


def test_kernels_refuse_what_they_do_not_take(cuda):
    enc, x, g, levels, step = _setup("ragged", cuda)
    lv = enc.eval_levels(0, 16, step)
    table = enc.table.detach()
    with pytest.raises(ValueError):
        hashgrid_eval.encode_features(x.cpu(), table.cpu(), lv)
    with pytest.raises(ValueError):
        hashgrid_eval.encode_features(x, table[:, :100], lv)
    with pytest.raises(TypeError):
        hashgrid_eval.encode_features(x.double(), table, lv)
    with pytest.raises(ValueError):
        hashgrid_eval.encode_position_grad(x, table, g[:, :4], lv)
