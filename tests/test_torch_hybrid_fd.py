"""Port parity for the flagship's finite-difference geometry against the
JAX package: the hash grid's ``encode_with_grad`` (features, Jacobian
columns, table and x gradients) and ``encode_axis_probes`` (the base
point and six axis probes from one 32-point neighbourhood gather, table
gradients), and ``VolumeSDF.forward`` in the hybrid-FD, plain-FD and
analytic + curvature-probe branches, with the same curvature directions
on both sides, and the gradient of the curvature term (second order
through the probe's gradient).

The JAX encodes take their table gradient through ``table_grad_lookup``
in Pallas interpret mode (as ``tests/test_scatter_pallas.py`` runs it;
one case each, interpret mode is slow) and through the plain XLA path;
the geometry's JAX side is jitted.

Tolerances: encode features, columns and table gradients 2e-6
absolute, as ``tests/test_shared_probes.py`` holds the fused probe
encode.  The geometry's sdf, features and gradients 1e-5 (each side
sums in its own order; the FD gradient divides probe differences by
2 eps, which scales their float32 rounding by 1 / eps).  The curvature
``arccos(dot) / pi`` 2e-5 plus the arccos slope times 5e-7 of the dot
(4 float32 ulps near 1: the angle of two nearly parallel gradients
moves by ~1e-5 per ulp of their dot).  Parameter gradients 1e-3 of each
tensor's largest entry, as ``tests/test_torch_neus.py`` holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu.models.geometry import VolumeSDF as JaxVolumeSDF
from rise_sdf_tpu.ops.hashgrid import HashGridEncoding as JaxHashGrid
from rise_sdf_tpu.presets import geometry_cfg
from rise_sdf_tpu_torch import bridge
from rise_sdf_tpu_torch.models.geometry import VolumeSDF
from rise_sdf_tpu_torch.ops.hashgrid import HashGridEncoding

ENC = dict(rtol=0, atol=2e-6)
GEO = dict(rtol=1e-5, atol=1e-5)
AXES = (0, 0, 1, 1, 2, 2)
SIGNS = (1.0, -1.0, 1.0, -1.0, 1.0, -1.0)


def _grid_cfg(scatter_impl):
    # base 4, 2^8 rows: levels 0-2 dense-indexed, 3-5 hashed
    return {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2,
            "log2_hashmap_size": 8, "base_resolution": 4,
            "per_level_scale": 1.5, "scatter_impl": scatter_impl}


def _grids(scatter_impl, seed=1):
    cfg = _grid_cfg(scatter_impl)
    je = JaxHashGrid(3, cfg)
    table = (0.1 * np.random.default_rng(seed).standard_normal(
        (6, 256, 2))).astype(np.float32)
    te = HashGridEncoding(3, cfg)
    te.load_state_dict({"table": torch.from_numpy(table)})
    return je, te, table


def _probe_points(n, seed, edge=False):
    """Base points and their six axis probes one finest cell away,
    clipped to the unit cube (``edge``: clustered at the faces, where
    probes clip and the cell corner clamps)."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, 3)).astype(np.float32)
    if edge:
        u[: n // 2] *= 0.01
        u[n // 2:] = 1.0 - 0.01 * u[n // 2:]
    eps = 1.0 / float(int(4 * 1.5 ** 5))
    probes = []
    for axis, sign in zip(AXES, SIGNS):
        up = u.copy()
        up[:, axis] = np.clip(up[:, axis] + sign * eps, 0.0, 1.0)
        probes.append(up)
    return u, np.stack(probes)


@pytest.mark.parametrize("scatter_impl,levels", [
    ("pallas", None), ("xla", None), ("xla", (2, 5))],
    ids=["pallas_all", "xla_all", "xla_range2_5"])
def test_encode_with_grad_matches_jax(scatter_impl, levels):
    je, te, table = _grids(scatter_impl)
    x = np.random.default_rng(2).uniform(0.01, 0.99, (257, 3)).astype(
        np.float32)
    cots = np.random.default_rng(3).standard_normal((4, 257, 12)).astype(
        np.float32)

    def loss_jax(tb, xx):
        f, jac = je.encode_with_grad({"table": tb}, xx, levels=levels)
        return sum(jnp.sum(a * c) for a, c in zip((f,) + jac, cots)), \
            (f,) + jac

    (_, want), (gt_j, gx_j) = jax.value_and_grad(
        loss_jax, argnums=(0, 1), has_aux=True)(jnp.asarray(table),
                                                jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    f, jac = te.encode_with_grad(xt, levels=levels)
    got = (f,) + jac
    for g, w, name in zip(got, want, ("feats", "jx", "jy", "jz")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **ENC)
    assert float(jnp.abs(want[1]).max()) > 0.1
    sum(torch.sum(a * torch.from_numpy(c)) for a, c in zip(got, cots)
        ).backward()
    np.testing.assert_allclose(te.table.grad.numpy(), np.asarray(gt_j),
                               **ENC)
    # x-gradients reach ~500 (res x table x cotangent, summed over
    # the four outputs): 1e-4 of the largest
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-4,
                               atol=1e-4 * float(jnp.abs(gx_j).max()))
    # the columns reuse the features' rows: one gather, one K1 launch
    assert torch.count_nonzero(te.table.grad).item() > 0


@pytest.mark.parametrize("scatter_impl,levels,edge", [
    ("pallas", None, False), ("xla", None, False), ("xla", None, True),
    ("xla", (2, 5), False), ("xla", (2, 5), True)],
    ids=["pallas_all", "xla_all", "xla_all_edge", "xla_range2_5",
         "xla_range2_5_edge"])
def test_encode_axis_probes_matches_jax(scatter_impl, levels, edge):
    """Features of the base point and the six probes, and the table
    gradient of a random cotangent on them, against the JAX fused
    encode; the port's fused encode also equals its per-point encode."""
    je, te, table = _grids(scatter_impl, seed=4)
    u, up = _probe_points(129, 5, edge)
    cot = np.random.default_rng(6).standard_normal((7, 129, 12)).astype(
        np.float32)

    def loss_jax(tb):
        out = je.encode_axis_probes({"table": tb}, jnp.asarray(u),
                                    jnp.asarray(up), AXES, levels=levels)
        return jnp.sum(out * cot), out

    (_, want), gt_j = jax.value_and_grad(loss_jax, has_aux=True)(
        jnp.asarray(table))
    got = te.encode_axis_probes(torch.from_numpy(u), torch.from_numpy(up),
                                AXES, levels=levels)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ENC)
    with torch.no_grad():
        ref = torch.stack([te(torch.from_numpy(p), levels=levels)
                           for p in (u, *up)])
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), **ENC)
    torch.sum(got * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(te.table.grad.numpy(), np.asarray(gt_j),
                               **ENC)


# --------------------------------------------------------------------- #
# VolumeSDF
# --------------------------------------------------------------------- #


def _sdf_cfg(**kw):
    """``tests/test_hybrid_fd.py``'s geometry: 6 progressive levels from
    resolution 8 by 1.45, a 2^12 table, every 4th sample probed for
    curvature."""
    cfg = geometry_cfg("finite_difference", progressive=True, levels=6)
    cfg["xyz_encoding_config"]["per_level_scale"] = 1.45
    cfg["xyz_encoding_config"]["base_resolution"] = 8
    cfg["curvature_probe_frac"] = 0.25
    cfg.update(kw)
    return cfg


def _sdf_pair(**kw):
    """JAX and port geometry on the same params: the JAX init with a
    noise table and MLP weights moved off the sphere init (its
    feature-input columns start at zero)."""
    cfg = _sdf_cfg(**kw)
    jg = JaxVolumeSDF(cfg)
    params = jg.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda v: v + (0.1 if v.ndim == 3 else 0.05)
        * rng.standard_normal(v.shape).astype(np.float32), params)
    tg = VolumeSDF(cfg)
    flat = bridge.flatten_params(params, "params/geometry")
    tg.load_state_dict({k[len("geometry."):]: v for k, v in
                        bridge.from_jax_params(flat).items()}, strict=True)
    return jg, params, tg


def _x(n, seed):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 3)).astype(
        np.float32)


def _laplace_dirs(rng, n, stride):
    """The JAX probe's draws for ``n`` samples: uniform [0, 1)^3."""
    return np.asarray(jax.random.uniform(rng, (-(-n // stride), 3)))


@pytest.mark.parametrize("branch,levels,step,kw", [
    ("hybrid", 6, 1000, {}),
    ("hybrid", 4, 30, {}),                       # coarse band 1 level
    ("hybrid", 4, 30, {"fd_shared_probes": False}),
    ("hybrid", 4, 30, {"fd_fine_k": 1}),         # coarse band 3 levels
    ("hybrid", 6, 1000, {"fd_probe_mode": "tetra4"}),
    ("plain_fd", None, 25, {}),
    ("plain_fd", 6, 1000, {"fd_taylor_coarse": False}),
    ("analytic", 6, 1000, {"grad_type": "analytic"}),
], ids=["hybrid_all", "hybrid_4", "hybrid_4_unshared", "hybrid_fine1",
        "hybrid_tetra", "plain_fd_progressive", "plain_fd_static",
        "analytic"])
def test_forward_matches_jax(branch, levels, step, kw):
    jg, params, tg = _sdf_pair(**kw)
    x = _x(257, 8)
    rng = jax.random.PRNGKey(9)
    want = jax.jit(lambda p, xx: jg.forward(
        p, xx, step, with_grad=True, with_laplace=True, rng=rng,
        levels=levels))(params, jnp.asarray(x))
    dirs = torch.from_numpy(_laplace_dirs(rng, 257, tg.laplace_stride))
    got = tg(torch.from_numpy(x), step, with_grad=True, with_laplace=True,
             laplace_dirs=dirs, levels=levels)
    assert got["laplace"].shape == (65,)
    for k in ("sdf", "grad", "feature"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k, **GEO)
    _assert_laplace_close(got["laplace"].detach().numpy(),
                          np.asarray(want["laplace"]))
    # some probes' dots lie below the clamp at 1 - 1e-6
    floor = np.arccos(np.float32(1.0 - 1e-6)) / np.pi
    assert (np.asarray(want["laplace"]) > 1.05 * floor).any()


def _assert_laplace_close(got, want):
    slope = 1.0 / (np.pi * np.maximum(np.sin(np.pi * want), 1e-12))
    np.testing.assert_array_less(np.abs(got - want), 2e-5 + 5e-7 * slope)


def test_static_schedule_matches_jax():
    """Open levels, the progressive eps, the fine-band depth and the
    shared-probe gate."""
    jg, _, tg = _sdf_pair()
    for step in (0, 9, 15, 25, 31, 1000):
        assert tg.open_levels(step) == jg.open_levels(step)
        lv = jg.open_levels(step)
        assert tg.fd_eps(step, lv) == pytest.approx(
            float(jg.fd_eps(step, lv)), rel=1e-7)
        assert tg.fd_eps(step) == pytest.approx(float(jg.fd_eps(step)),
                                                rel=1e-6)
    assert tg._fd_fine_k() == jg._fd_fine_k() == 4
    assert tg._shared_probes_ok(4) and jg._shared_probes_ok(4)
    for kw, k in (({"fd_fine_k": 3}, 3), ({"fd_fine_k": 0}, 1)):
        assert VolumeSDF(_sdf_cfg(**kw))._fd_fine_k() == k \
            == JaxVolumeSDF(_sdf_cfg(**kw))._fd_fine_k()
    numeric = _sdf_cfg(finite_difference_eps=0.01)
    assert VolumeSDF(numeric)._shared_probes_ok(6) \
        == JaxVolumeSDF(numeric)._shared_probes_ok(6)


@pytest.mark.parametrize("levels", [4, None], ids=["hybrid", "plain_fd"])
def test_curvature_and_eikonal_param_grads_match_jax(levels):
    """Gradient of the curvature mean plus the eikonal and SDF terms
    with respect to every parameter: second order through the curvature
    probe's gradient (the table side through the encode once)."""
    jg, params, tg = _sdf_pair()
    x = _x(129, 10)
    rng = jax.random.PRNGKey(11)
    step = 30 if levels else 25

    def loss_jax(p):
        out = jg.forward(p, jnp.asarray(x), step, with_grad=True,
                         with_laplace=True, rng=rng, levels=levels)
        gn = jnp.sqrt(jnp.sum(out["grad"] ** 2, -1) + 1e-12)
        return jnp.mean(jnp.abs(out["laplace"])) \
            + jnp.mean((gn - 1.0) ** 2) + jnp.mean(out["sdf"] ** 2)

    want = bridge.flatten_params(jax.jit(jax.grad(loss_jax))(params),
                                 "params/geometry")
    dirs = torch.from_numpy(_laplace_dirs(rng, 129, tg.laplace_stride))
    out = tg(torch.from_numpy(x), step, with_grad=True, with_laplace=True,
             laplace_dirs=dirs, levels=levels, create_graph=True)
    gn = torch.sqrt(torch.sum(out["grad"] ** 2, -1) + 1e-12)
    loss = torch.mean(torch.abs(out["laplace"])) \
        + torch.mean((gn - 1.0) ** 2) + torch.mean(out["sdf"] ** 2)
    loss.backward()
    got = {"params/geometry/" + k.replace(".", "/").replace(
        "encoding/encoding", "encoding"): p.grad.numpy()
        for k, p in tg.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.any(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                   atol=1e-3 * float(np.abs(want[k]).max()),
                                   err_msg=k)


def test_curvature_term_alone_reaches_the_table():
    """The curvature mean's own table gradient (the probe's gradient
    differentiated once more) is nonzero and matches JAX."""
    jg, params, tg = _sdf_pair()
    x = _x(129, 12)
    rng = jax.random.PRNGKey(13)

    def loss_jax(p):
        out = jg.forward(p, jnp.asarray(x), 30, with_grad=True,
                         with_laplace=True, rng=rng, levels=4)
        return jnp.mean(out["laplace"])

    want = np.asarray(jax.jit(jax.grad(loss_jax))(params)["encoding"][
        "table"])
    dirs = torch.from_numpy(_laplace_dirs(rng, 129, tg.laplace_stride))
    out = tg(torch.from_numpy(x), 30, with_grad=True, with_laplace=True,
             laplace_dirs=dirs, levels=4, create_graph=True)
    torch.mean(out["laplace"]).backward()
    got = tg.encoding.encoding.table.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * float(np.abs(want).max()))
