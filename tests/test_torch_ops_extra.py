"""Port parity: the four ops that nothing calls yet (``ops/resample.py``,
``ops/grid_sample.py``, ``ops/renderutils_misc.py``,
``ops/rendering_drivers.py``) against the JAX package's, on the CPU.

Inputs come from numpy with a seed.  Tolerances: max abs 1e-5 on
interpolated values, resampled intervals, normals, transforms and
accumulated channels; losses relative 1e-5.  ``grid_sample`` is also
held to second order (the property ``tests/test_ops_extra.py`` checks
with ``jax.hessian``): ``torch.autograd.gradcheck`` and
``gradgradcheck`` in float64 against finite differences, and its
Hessian-vector product equal to JAX's.  The resampler takes JAX's
draws.  The goldens of ``test_renderutils_misc.py`` and the checks of
``test_rendering_drivers.py`` and ``test_ops_extra.py`` run on the
port too.

The public helpers nothing calls in either package (``sample_cubemap_mips``,
``binary_cross_entropy``, ``weighted_mse``, ``weighted_l1``,
``srgb_to_rgb``, ``scale_anything``, ``cell_positions`` with the same
jitter draws, ``update_grid``) are held to JAX's at 1e-6 (relative for
the losses), one case each of one test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu.ops import grid_sample as jgs
from rise_sdf_tpu.ops import march as jmarch
from rise_sdf_tpu.ops import rendering_drivers as jrd
from rise_sdf_tpu.ops import renderutils_misc as jru
from rise_sdf_tpu.ops.resample import ray_resampling as jresample
from rise_sdf_tpu_torch.ops import grid_sample as tgs
from rise_sdf_tpu_torch.ops import march as tmarch
from rise_sdf_tpu_torch.ops import rendering_drivers as trd
from rise_sdf_tpu_torch.ops import renderutils_misc as tru
from rise_sdf_tpu_torch.ops.resample import ray_resampling as tresample
from test_renderutils_misc import GOLD, IN, LOSS_GOLD

TOL = dict(rtol=0, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----- resample ------------------------------------------------------- #

def _intervals(seed, r=6, s=32):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0, 4, (r, s + 1)), 1).astype(np.float32)
    w = rng.exponential(size=(r, s)).astype(np.float32)
    w[:, ::5] = 0.0
    w[0, :] = 0.0  # a ray with no weight: the padding floor alone
    live = rng.uniform(size=(r, s)) > 0.2
    return edges[:, :-1], edges[:, 1:], w, live


@pytest.mark.parametrize("jitter", [False, True])
def test_ray_resampling_matches_jax(jitter):
    ts, te, w, live = _intervals(0)
    key = jax.random.PRNGKey(1) if jitter else None
    want = jresample(*map(jnp.asarray, (ts, te, w, live)), 24, rng=key)
    u = _t(jax.random.uniform(key, (6, 24))) if jitter else None
    got = tresample(*map(_t, (ts, te, w, live)), 24, u=u)
    for g, x in zip(got, want):
        assert tuple(g.shape) == x.shape == (6, 24)
        np.testing.assert_allclose(g.numpy(), np.asarray(x), **TOL)
    # a generator draws the same u
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = tresample(*map(_t, (ts, te, w, live)), 24, generator=g1)
    b = tresample(*map(_t, (ts, te, w, live)), 24,
                  u=torch.rand((6, 24), generator=g2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_ray_resampling_concentrates_on_the_port():
    t = torch.linspace(0, 1, 33)
    ts, te = t[:-1].repeat(2, 1), t[1:].repeat(2, 1)
    w = torch.zeros(2, 32)
    w[:, 16] = 100.0
    nts, nte = tresample(ts, te, w, torch.ones(2, 32, dtype=torch.bool), 16)
    mids = (0.5 * (nts + nte)).numpy()
    assert (np.abs(mids - 0.516) < 0.1).mean() > 0.5
    assert (np.diff(nts.numpy(), axis=1) >= -1e-6).all()


# ----- grid_sample ---------------------------------------------------- #

def test_grid_sample_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((5, 7, 3)).astype(np.float32)
    vol = rng.standard_normal((4, 5, 6, 2)).astype(np.float32)
    g2 = rng.uniform(-1.2, 1.2, (40, 2)).astype(np.float32)
    g3 = rng.uniform(-1.2, 1.2, (8, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgs.grid_sample_2d(_t(img), _t(g2)).numpy(),
        np.asarray(jgs.grid_sample_2d(jnp.asarray(img), jnp.asarray(g2))),
        **TOL)
    got = tgs.grid_sample_3d(_t(vol), _t(g3)).numpy()
    assert got.shape == (8, 5, 2)
    np.testing.assert_allclose(got, np.asarray(jgs.grid_sample_3d(
        jnp.asarray(vol), jnp.asarray(g3))), **TOL)
    # the checks of tests/test_ops_extra.py
    ar = torch.arange(12.0).reshape(3, 4, 1)
    out = tgs.grid_sample_2d(ar, torch.tensor([[-1.0, -1.0], [1.0, 1.0],
                                               [0.0, 0.0]]))
    np.testing.assert_allclose(out[:, 0].numpy(), [0.0, 11.0, 5.5],
                               atol=1e-5)
    np.testing.assert_allclose(tgs.grid_sample_3d(
        torch.full((4, 5, 6, 2), 3.0), _t(g3)).numpy(), 3.0, atol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_grid_sample_second_order(dim):
    """gradcheck and gradgradcheck in float64 in both the values and the
    sample positions (off the texel edges, where it is smooth), and the
    Hessian-vector product of a loss equal to JAX's."""
    rng = np.random.default_rng(4 + dim)
    shape = (3, 4, 2) if dim == 2 else (3, 3, 4, 2)
    fn = tgs.grid_sample_2d if dim == 2 else tgs.grid_sample_3d
    jfn = jgs.grid_sample_2d if dim == 2 else jgs.grid_sample_3d
    vals = torch.tensor(rng.standard_normal(shape), dtype=torch.float64,
                        requires_grad=True)
    # positions inside texels, away from the lattice
    idx = rng.integers(0, 2, (5, dim)) + rng.uniform(0.2, 0.8, (5, dim))
    size = np.array(shape[:-1][::-1], np.float64)
    g = torch.tensor(idx / (size - 1) * 2 - 1, requires_grad=True)
    assert torch.autograd.gradcheck(fn, (vals, g))
    assert torch.autograd.gradgradcheck(fn, (vals, g))
    with jax.enable_x64():
        jv, jg = jnp.asarray(vals.detach().numpy()), \
            jnp.asarray(g.detach().numpy())
        v = np.random.default_rng(9).standard_normal(jg.shape)

        def loss(grid):
            return jnp.sum(jfn(jv, grid) ** 2)

        want = np.asarray(jax.jvp(jax.grad(loss), (jg,), (jnp.asarray(v),))[1])
    gg = torch.autograd.grad(torch.sum(fn(vals.detach(), g) ** 2), g,
                             create_graph=True)[0]
    got = torch.autograd.grad(gg, g, grad_outputs=_t(v))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


# ----- renderutils_misc ----------------------------------------------- #

def _a(k):
    return np.asarray(IN[k], np.float32)


@pytest.mark.parametrize("two_sided,opengl,gold", [
    (True, True, "psn_ts_gl"), (False, False, "psn_1s_ocv"),
    (True, False, None), (False, True, None)])
def test_prepare_shading_normal_matches_jax(two_sided, opengl, gold):
    keys = ("pos", "view_pos", "pert", "snrm", "stng", "gnrm")
    kw = dict(two_sided_shading=two_sided, opengl=opengl)
    got = tru.prepare_shading_normal(*[_t(_a(k)) for k in keys], **kw)
    want = jru.prepare_shading_normal(*[jnp.asarray(_a(k)) for k in keys],
                                      **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if gold:
        np.testing.assert_allclose(got.numpy(), GOLD[gold], rtol=2e-4,
                                   atol=2e-5)


def test_xfm_and_reflect_match_jax():
    rng = np.random.default_rng(6)
    pts = rng.standard_normal((2, 5, 3)).astype(np.float32)
    mat = rng.standard_normal((2, 4, 4)).astype(np.float32)
    for name in ("xfm_points", "xfm_vectors"):
        np.testing.assert_allclose(
            getattr(tru, name)(_t(pts), _t(mat)).numpy(),
            np.asarray(getattr(jru, name)(jnp.asarray(pts),
                                          jnp.asarray(mat))), **TOL)
    n = pts[0] / np.linalg.norm(pts[0], axis=-1, keepdims=True)
    np.testing.assert_allclose(tru.reflect(_t(pts[1]), _t(n)).numpy(),
                               np.asarray(jru.reflect(jnp.asarray(pts[1]),
                                                      jnp.asarray(n))),
                               **TOL)
    mat = torch.tensor([[0.0, -1.0, 0.0, 2.0], [1.0, 0.0, 0.0, -1.0],
                        [0.0, 0.0, 1.0, 0.5], [0.0, 0.0, 0.0, 1.0]])
    p = torch.tensor([[1.0, 0.0, 0.0], [0.0, 2.0, 3.0]])
    np.testing.assert_allclose(tru.xfm_points(p, mat).numpy(),
                               [[2.0, 0.0, 0.5, 1.0], [0.0, -1.0, 3.5, 1.0]],
                               atol=1e-6)


def test_image_losses_match_jax_and_goldens():
    i = np.arange(2 * 8 * 8 * 3, dtype=np.float64).reshape(2, 8, 8, 3)
    img = (np.sin(i * 0.37) ** 2 * 5.0).astype(np.float32)
    tgt = (np.cos(i * 0.21) ** 2 * 4.0).astype(np.float32)
    for (loss, tm), gold in LOSS_GOLD.items():
        got = float(tru.image_loss(_t(img), _t(tgt), loss, tm))
        want = float(jru.image_loss(jnp.asarray(img), jnp.asarray(tgt), loss,
                                    tm))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   err_msg=f"{loss}/{tm}")
        np.testing.assert_allclose(got, gold, rtol=2e-4,
                                   err_msg=f"{loss}/{tm}")


# ----- rendering drivers ---------------------------------------------- #

def _samples(lib, t, n_rays=8, capacity=2048):
    z = np.linspace(-0.2, 0.2, n_rays, dtype=np.float32)
    d = np.stack([z, z * 0.3, np.ones_like(z)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.asarray([[0.0, 0.0, -3.0]], np.float32), (n_rays, 1))
    rs = lib.march_rays(t(o), t(d), aabb_min=t(np.full(3, -1.5, np.float32)),
                        aabb_max=t(np.full(3, 1.5, np.float32)),
                        step_size=0.05, num_samples=128, capacity=capacity,
                        grid_binary=None)
    return rs, d


def _field(xp, stack, full, tile):
    def fn(ts, te, ridx):
        t_mid = 0.5 * (ts + te)
        n = ts.shape[0]
        return {
            "rgb": stack([xp.sin(t_mid) * 0.5 + 0.5,
                          xp.cos(t_mid) * 0.5 + 0.5, full((n,), 0.3)]),
            "alpha": full((n,), 0.1) + 0.05 * xp.sin(7 * t_mid),
            "normal": tile([0.0, 0.0, 1.0], n),
            "albedo": full((n, 3), 0.6),
            "roughness": full((n,), 0.4),
            "metallic": full((n,), 0.2),
            "sdf": t_mid - 1.0,
            "sdf_grad": tile([1.0, 0.0, 0.0], n)}
    return fn


JFIELD = _field(jnp, lambda v: jnp.stack(v, -1), jnp.full,
                lambda r, n: jnp.tile(jnp.asarray([r]), (n, 1)))
TFIELD = _field(torch, lambda v: torch.stack(v, -1),
                lambda s, v: torch.full(s, v),
                lambda r, n: torch.tensor([r]).repeat(n, 1))


def _sigma(field, xp_log):
    def fn(ts, te, ridx):
        out = dict(field(ts, te, ridx))
        alpha = out.pop("alpha")
        out["sigma"] = -xp_log(1 - alpha) / (te - ts)
        return out
    return fn


@pytest.mark.parametrize("driver", [
    "rendering", "rendering_with_normals", "rendering_with_normals_sdf",
    "rendering_with_normals_mats", "rendering_with_normals_mats_sdf",
    "rendering_with_normals_mats_sdf_dir", "secondary_rendering",
    "rendering_sigma"])
def test_rendering_driver_matches_jax(driver):
    jrs, d = _samples(jmarch, jnp.asarray)
    trs, _ = _samples(tmarch, torch.from_numpy)
    np.testing.assert_allclose(trs.t_starts.numpy(),
                               np.asarray(jrs.t_starts), **TOL)
    jf, tf = JFIELD, TFIELD
    name = driver
    if driver == "rendering_sigma":
        name = "rendering"
        jf, tf = _sigma(jf, jnp.log), _sigma(tf, torch.log)
    args, kw = (), {}
    if name.endswith("_dir"):
        args = (d,)
    if name != "secondary_rendering":
        kw = {"render_bkgd": np.ones(3, np.float32)}
    want = getattr(jrd, name)(jrs, jf, 8, *map(jnp.asarray, args),
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    got = getattr(trd, name)(trs, tf, 8, *map(_t, args),
                             **{k: _t(v) for k, v in kw.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)


def test_rendering_driver_checks_on_the_port():
    """The checks of ``tests/test_rendering_drivers.py``."""
    rs, d = _samples(tmarch, torch.from_numpy)

    def field(ts, te, ridx):
        out = TFIELD(ts, te, ridx)
        out["alpha"] = torch.full_like(ts, 0.1)
        return out

    res = trd.rendering(rs, field, 8, render_bkgd=torch.ones(3))
    assert res["comp_rgb"].shape == (8, 3)
    assert float(res["opacity"].min()) > 0.8
    res2 = trd.rendering_with_normals_mats(rs, field, 8)
    np.testing.assert_allclose(res2["comp_albedo"].numpy(),
                               np.broadcast_to(0.6 * res2["opacity"].numpy(),
                                               (8, 3)), atol=1e-5)
    np.testing.assert_allclose(res2["comp_metallic"].numpy(),
                               0.2 * res2["opacity"].numpy(), atol=1e-5)
    b = trd.rendering(rs, _sigma(field, torch.log), 8)
    np.testing.assert_allclose(b["comp_rgb"].numpy(),
                               trd.rendering(rs, field, 8)["comp_rgb"].numpy(),
                               rtol=1e-4, atol=1e-5)
    res = trd.rendering_with_normals_mats_sdf_dir(rs, field, 8, _t(d))
    assert "sdf_samples" in res and "sdf_grad_samples" in res
    assert res["dirs_samples"].shape == (rs.t_starts.shape[0], 3)
    tr = trd.secondary_rendering(rs, field, 8)["transmittance"].numpy()
    assert tr.shape == (8, 1) and ((tr >= -1e-5) & (tr <= 1 + 1e-5)).all()
    np.testing.assert_allclose(
        tr, 1.0 - trd.rendering(rs, field, 8)["opacity"].numpy(), atol=1e-5)


# ----- the helpers nothing calls -------------------------------------- #

def _helper_pair(name, rng):
    """(JAX value, port value) of helper ``name`` on inputs from ``rng``."""
    from rise_sdf_tpu.ops import cubemap as jcube
    from rise_sdf_tpu.ops import grid as jgrid
    from rise_sdf_tpu.systems import criterions as jcrit
    from rise_sdf_tpu.utils import color as jcolor
    from rise_sdf_tpu.utils import misc as jmisc
    from rise_sdf_tpu_torch.ops import cubemap as tcube
    from rise_sdf_tpu_torch.ops import grid as tgrid
    from rise_sdf_tpu_torch.systems import criterions as tcrit
    from rise_sdf_tpu_torch.utils import color as tcolor
    from rise_sdf_tpu_torch.utils import misc as tmisc

    def f32(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    if name == "sample_cubemap_mips":
        mips = [f32(6, r, r, 3) for r in (16, 8, 4, 2)]
        dirs = f32(500, 3, lo=-1.0)
        level = f32(500, lo=-0.5, hi=3.5)  # both clamps bite
        return (jcube.sample_cubemap_mips([jnp.asarray(m) for m in mips],
                                          jnp.asarray(dirs),
                                          jnp.asarray(level)),
                tcube.sample_cubemap_mips([_t(m) for m in mips], _t(dirs),
                                          _t(level)))
    if name == "binary_cross_entropy":
        x, y = f32(300, lo=0.01, hi=0.99), f32(300)
        return (jcrit.binary_cross_entropy(x, y),
                tcrit.binary_cross_entropy(_t(x), _t(y)))
    if name in ("weighted_mse", "weighted_l1"):
        a, b, w = f32(64, 3), f32(64, 3), f32(64, 1)
        return ([getattr(jcrit, name)(a, b, w), getattr(jcrit, name)(a, b)],
                [getattr(tcrit, name)(_t(a), _t(b), _t(w)),
                 getattr(tcrit, name)(_t(a), _t(b))])
    if name == "srgb_to_rgb":
        x = f32(1000, lo=-0.1, hi=1.2)
        return jcolor.srgb_to_rgb(x), tcolor.srgb_to_rgb(_t(x))
    if name == "scale_anything":
        x = f32(100, lo=-2.0, hi=3.0)
        return (jmisc.scale_anything(x, (-2.0, 3.0), (0.5, -1.5)),
                tmisc.scale_anything(_t(x), (-2.0, 3.0), (0.5, -1.5)))
    if name == "cell_positions":
        lo, hi = np.full(3, -1.5, np.float32), np.full(3, 1.5, np.float32)
        key = jax.random.PRNGKey(3)
        u = np.asarray(jax.random.uniform(key, (8 ** 3, 3)))
        return ([jgrid.cell_positions(8, lo, hi, key),
                 jgrid.cell_positions(8, lo, hi)],
                [tgrid.cell_positions(8, _t(lo), _t(hi), _t(u)),
                 tgrid.cell_positions(8, _t(lo), _t(hi))])
    if name == "update_grid":
        occs, new = f32(512) * 0.02, f32(512) * 0.015
        want = jgrid.update_grid(jgrid.OccupancyGridState(
            occs=jnp.asarray(occs), binary=jnp.ones(512, bool)), new)
        got = tgrid.update_grid((_t(occs), torch.ones(512, dtype=torch.bool)),
                                _t(new))
        assert 0 < int(got[1].sum()) < 512
        return [want.occs, want.binary], list(got)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "sample_cubemap_mips", "binary_cross_entropy", "weighted_mse",
    "weighted_l1", "srgb_to_rgb", "scale_anything", "cell_positions",
    "update_grid"])
def test_uncalled_helpers_match_jax(name):
    want, got = _helper_pair(name, np.random.default_rng(11))
    if not isinstance(want, list):
        want, got = [want], [got]
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
