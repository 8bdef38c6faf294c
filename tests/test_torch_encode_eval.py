"""The hash-grid encode where no graph is kept (``EvalEncode``, E1 on the
card) on the CPU: which callers ask for it (``VolumeSDF`` by grad mode),
that CPU tensors, float64 and a row-sharded table run the chain, E1's
plain counterpart, as they are, the level constants E1 takes against
the chain's, and the ``Function``'s wiring around stand-in kernels.  The
kernels themselves against the chain, over ``CASES`` and at the render's
and the bake's shapes: ``tests/test_torch_cuda_encode_eval.py``."""

import pytest
import torch

from rise_sdf_tpu_torch import presets, trace
from rise_sdf_tpu_torch.models.geometry import VolumeSDF
from rise_sdf_tpu_torch.ops import hashgrid, hashgrid_eval
from rise_sdf_tpu_torch.ops.hashgrid import EvalEncode, HashGridEncoding

TINY = dict(presets.geometry_cfg(levels=4)["xyz_encoding_config"])
# the flagship's level constants (configs/split-mixed-occ-tensoir.yaml):
# 3 dense levels, then 13 hashed into 2^19 rows
FLAGSHIP = {"otype": "ProgressiveBandHashGrid", "n_levels": 16,
            "start_level": 6, "start_step": 6000, "update_steps": 500,
            "n_features_per_level": 2, "log2_hashmap_size": 19,
            "base_resolution": 32, "per_level_scale": 1.447269237440378}
# (config, levels, step): every level; 14 of 16 open in range; the mask
# closing levels 8 to 15 (step 7000 opens 6 + 2); a range inside the
# dense prefix, one across the dense/hashed split, one past it
CASES = {
    "tiny": (TINY, None, None),
    "tiny_range": (TINY, (1, 3), None),
    "flagship": (FLAGSHIP, None, None),
    "flagship_open14": (FLAGSHIP, 14, None),
    "flagship_masked": (FLAGSHIP, None, 7000),
    "flagship_dense": (FLAGSHIP, (0, 3), None),
    "flagship_split": (FLAGSHIP, (2, 9), 8000),
    "flagship_hashed": (FLAGSHIP, (5, 16), None),
}


def _encoding(cfg, seed=0):
    enc = HashGridEncoding(3, cfg)
    with torch.no_grad():
        enc.table.copy_(torch.randn(enc.table.shape,
                                    generator=torch.Generator()
                                    .manual_seed(seed)) * 0.1)
    return enc


def _points(n, seed=1):
    """Uniform points, with some on each face and corner of the cube."""
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(seed))
    x[0:8] = torch.tensor([[a, b, c] for a in (0.0, 1.0) for b in (0.0, 1.0)
                           for c in (0.0, 1.0)])
    for a in range(3):
        x[8 + 40 * a:28 + 40 * a, a] = 0.0
        x[28 + 40 * a:48 + 40 * a, a] = 1.0
    return x


@pytest.mark.parametrize("case", list(CASES))
def test_eval_levels_are_the_chains_constants(case):
    """What E1 takes (``eval_levels``) is what the chain uses: the range,
    each level's resolution and dense stride, T, the dense prefix, whose
    rows are E1's dense index, the hashed rows as E1's uint32 hash, and a
    mask under which exactly the chain's closed levels read zero."""
    cfg, levels, step = CASES[case]
    enc = _encoding(cfg)
    lo, hi = enc._level_range(levels, enc.n_levels)
    lv = enc.eval_levels(lo, hi, step)
    assert (lv.lo, lv.hi, lv.n_dense) == (lo, hi, enc.n_dense)
    assert lv.res == enc.level_res.tolist()
    assert lv.stride == enc.dense_stride.tolist()
    assert lv.table_size == enc.table.shape[1]
    x = _points(300)
    i0 = enc._cell(x, lo, hi)[0]
    rows = enc._corner_rows(i0, lo, hi)[..., 0]  # corner (0, 0, 0)
    u32 = 2 ** 32 - 1
    for l in range(lo, hi):
        cx, cy, cz = i0[:, l - lo].unbind(-1)
        if l < lv.n_dense:
            s = lv.stride[l]
            want = cx + s * (cy + s * cz)
        else:
            p = hashgrid._PRIMES
            want = (((cx * p[0]) & u32) ^ ((cy * p[1]) & u32)
                    ^ ((cz * p[2]) & u32)) & (lv.table_size - 1)
        assert torch.equal(rows[:, l - lo], want), l
    feats = enc._chain(x, step, lo, hi).view(300, enc.n_levels, -1)
    for l in range(enc.n_levels):
        closed = not lo <= l < hi or lv.mask[l] == 0.0
        assert bool((feats[:, l] == 0.0).all()) == closed, l


def test_eval_encode_levels_follow_the_mask():
    enc = _encoding(FLAGSHIP)
    lv = enc.eval_levels(2, 9, 7000)
    assert (lv.lo, lv.hi, lv.n_dense, lv.table_size) == (2, 9, 3, 2 ** 19)
    assert lv.mask == [1.0] * 8 + [0.0] * 8
    assert lv.res[:3] == [32.0, 46.0, 67.0] and lv.stride[:3] == [33, 47, 68]
    assert enc.eval_levels(0, 16, None).mask == [1.0] * 16


def test_eval_encode_is_once_differentiable(monkeypatch):
    """``EvalEncode`` around stand-ins for E1f and E1b (the kernels run on
    the card only): the forward hands E1f the points and the detached
    table, the backward hands E1b the saved pair and the cotangent and
    returns its gradient for the points alone; that gradient cannot be
    differentiated again."""
    enc = _encoding(TINY)
    lv = enc.eval_levels(0, 4, None)
    calls = []

    def features(x, table, levels):
        calls.append(("f", x, table, levels))
        return x.sum(1, keepdim=True).expand(-1, 8) * 2.0

    def position_grad(x, table, grad, levels):
        calls.append(("b", x, table, grad, levels))
        return grad[:, :3] * 3.0

    monkeypatch.setattr(hashgrid_eval, "encode_features", features)
    monkeypatch.setattr(hashgrid_eval, "encode_position_grad", position_grad)
    x = _points(64).requires_grad_(True)
    table = enc.table.detach()
    f = EvalEncode.apply(x, table, lv)
    assert f.grad_fn.name() == "EvalEncodeBackward"
    assert torch.equal(f, x.detach().sum(1, keepdim=True).expand(-1, 8) * 2)
    g = torch.randn((64, 8))
    gx, = torch.autograd.grad(f, x, g, create_graph=True)
    assert torch.equal(gx, g[:, :3] * 3.0)
    (_, xf, tf, lf), (_, xb, tb, gb, lb) = calls
    assert torch.equal(xf, x) and torch.equal(xb, x) and torch.equal(gb, g)
    assert tf is table and tb is table and lf is lv and lb is lv
    assert enc.table.grad is None
    with pytest.raises(RuntimeError):
        gx.sum().backward()


@pytest.fixture
def asked(monkeypatch):
    """The ``eval_encode`` that each encode call was given."""
    seen = []
    forward = HashGridEncoding.forward

    def spy(enc, x, *args, eval_encode=False, **kw):
        seen.append(eval_encode)
        return forward(enc, x, *args, eval_encode=eval_encode, **kw)

    monkeypatch.setattr(HashGridEncoding, "forward", spy)
    return seen


def _geometry(cfg=None):
    torch.manual_seed(0)
    geo = VolumeSDF(cfg or presets.geometry_cfg(levels=4))
    with torch.no_grad():
        geo.encoding.encoding.table.normal_(0.0, 0.1)
    return geo


def test_analytic_forward_under_no_grad_takes_the_eval_encode(asked):
    """Entered under ``no_grad``, the analytic forward asks for the eval
    encode (before its own ``enable_grad``); on CPU tensors the encoding
    runs the chain for it, so the outputs are the grad-enabled ones."""
    geo = _geometry()
    x = (torch.rand((200, 3)) * 2.0 - 1.0) * geo.radius
    want = geo(x, 5, grad_mode="analytic")
    assert asked == [False]
    with torch.no_grad(), trace.recording() as rec:
        got = geo(x, 5, grad_mode="analytic")
    assert asked == [False, True]
    assert rec.counts == {"encode.chain_points": [200]}
    assert geo.encoding.encoding.table.grad is None
    for k in ("sdf", "feature", "grad"):
        assert torch.equal(got[k], want[k].detach()), k


@pytest.mark.parametrize("how", ["sdf", "forward_no_grad", "plain_fd"])
def test_no_grad_callers_take_the_eval_encode(how, asked):
    geo = _geometry(presets.geometry_cfg("finite_difference", levels=4))
    x = (torch.rand((50, 3)) * 2.0 - 1.0) * geo.radius
    with torch.no_grad(), trace.recording() as rec:
        if how == "sdf":
            geo.sdf(x, 5)
        elif how == "forward_no_grad":
            geo(x, 5, with_grad=False)
        else:  # plain FD: the point and its 6 probes
            geo(x, 5, levels=None)
    points = {"sdf": [50], "forward_no_grad": [50], "plain_fd": [50, 300]}
    assert asked == [True] * len(points[how])
    assert rec.counts == {"encode.chain_points": points[how]}


def test_grad_enabled_keeps_the_chain_and_its_table_gradient(asked):
    """With grad enabled the encode is the chain, through G1 and K1: the
    geometry's loss reaches the table through K1, and the encode's table
    gradient is the one the chain's own body gives."""
    geo = _geometry()
    enc = geo.encoding.encoding
    x = (torch.rand((200, 3)) * 2.0 - 1.0) * geo.radius
    with trace.recording() as rec:
        out = geo(x, 5, grad_mode="analytic", create_graph=True)
        (out["sdf"].square().sum() + out["grad"].square().sum()).backward()
    assert asked == [False]
    assert rec.counts["encode.chain_points"] == [200]
    assert "encode.eval_points" not in rec.counts
    names = {s.name for s in rec.spans}
    assert {"kernel.g1", "kernel.k1"} <= names and "kernel.e1" not in names
    assert enc.table.grad is not None
    u = _points(200)
    g = torch.randn((200, enc.n_output_dims))
    got, = torch.autograd.grad(enc(u, 5), enc.table, g)
    want, = torch.autograd.grad(enc._chain(u, 5, 0, 4), enc.table, g)
    assert torch.equal(got, want)


def test_hybrid_fd_keeps_the_chain(asked):
    geo = _geometry(presets.geometry_cfg("finite_difference", levels=4))
    x = (torch.rand((40, 3)) * 2.0 - 1.0) * geo.radius
    with trace.recording() as rec:
        geo(x, 5, levels=4)
    assert set(rec.counts) == {"encode.chain_points"}
    assert not any(asked)


def test_float64_keeps_the_chain():
    """E1 is written for float32: a float64 encode (the card's float64
    checks against the CPU) takes the chain under ``no_grad`` too."""
    geo = _geometry().double()
    x = (torch.rand((30, 3), dtype=torch.float64) * 2.0 - 1.0) * geo.radius
    with torch.no_grad(), trace.recording() as rec:
        geo(x, 5, grad_mode="analytic")
    assert rec.counts == {"encode.chain_points": [30]}


def test_sharded_table_keeps_the_chain():
    """A row-sharded table takes the chain under ``no_grad`` too (which
    refuses a lookup without its model group); inside ``unsharded`` the
    whole table is encoded as an unsharded one (on CPU tensors the
    chain; on the card E1, ``tests/test_torch_cuda_encode_eval.py``)."""
    geo = _geometry()
    enc = geo.encoding.encoding
    full = enc.table.detach().clone()
    x = (torch.rand((30, 3)) * 2.0 - 1.0) * geo.radius
    want = geo.sdf(x, 5).detach()
    enc.shard_table(2, 0, None)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="without its model group"):
            geo.sdf(x, 5)
        with enc.unsharded(full), trace.recording() as rec:
            got = geo.sdf(x, 5)
    assert rec.counts == {"encode.chain_points": [30]}
    assert torch.equal(got, want)


def test_kernel_wrappers_refuse_cpu_tensors():
    enc = _encoding(TINY)
    lv = enc.eval_levels(0, 4, None)
    x = _points(10)
    with pytest.raises(ValueError, match="cuda"):
        hashgrid_eval.encode_features(x, enc.table.detach(), lv)
    with pytest.raises(ValueError, match="cuda"):
        hashgrid_eval.encode_position_grad(
            x, enc.table.detach(), torch.zeros((10, 8)), lv)
    with pytest.raises(ValueError, match="cuda"):  # no fallback
        EvalEncode.apply(x.requires_grad_(True), enc.table.detach(), lv)
