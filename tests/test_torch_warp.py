"""Port parity: ``rise_sdf_tpu_torch/ops/warp.py`` and the ``brdf-ggx``
scatterer against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed: unit vectors, uniforms in
[0, 1), roughness in [0.05, 1].  Every function of ``warp.py`` takes the
same float32 inputs on both sides.  Tolerances: bounded outputs
(directions, frames, Fresnel, masking, BSDF values) max abs 1e-5;
densities (NDFs, pdfs) relative 1e-5 with an absolute floor of 1e-6.
(Measured: at most 3.6e-7 absolute on the samplers, 1.5e-6 relative
on the densities.)  The scatterer's ``sample`` takes JAX's own draws
(``jax.random.uniform`` on the keys its ``sample`` splits), so the
directions compare one to one.  The goldens of ``test_bsdf_golden.py``
and the properties of ``test_warp_sggx.py`` are checked on the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu.models.scatterer import BRDFGGXScatterer as JScatterer
from rise_sdf_tpu.ops import warp as jw
from rise_sdf_tpu_torch import models
from rise_sdf_tpu_torch.ops import warp as tw
from test_bsdf_golden import GOLDEN, INPUTS

N = 512
BOUNDED = dict(rtol=0, atol=1e-5)
DENSITY = dict(rtol=1e-5, atol=1e-6)


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _upper(rng, n=N):
    v = _unit(rng, n)
    v[:, 2] = np.abs(v[:, 2]) + 0.05
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(0)
    n = _unit(rng)
    wi = _unit(rng)
    # half of wi in n's hemisphere, so masks and clamps take both sides
    wi[: N // 2] *= np.sign(np.sum(wi[: N // 2] * n[: N // 2], -1))[:, None]
    return {
        "n": n, "wi": wi, "wo": _unit(rng), "wl": _upper(rng),
        "wl2": _upper(rng),
        "u": rng.uniform(size=(N, 2)).astype(np.float32),
        "u2": rng.uniform(size=(N, 2)).astype(np.float32),
        "alpha": rng.uniform(0.05, 1.0, N).astype(np.float32),
        "alpha2": rng.uniform(0.05, 1.0, N).astype(np.float32),
        "cos": rng.uniform(-0.2, 1.0, N).astype(np.float32),
        "col": rng.uniform(size=(N, 3)).astype(np.float32),
        "col1": rng.uniform(size=(N, 1)).astype(np.float32),
        "arm": rng.uniform(size=(N, 3)).astype(np.float32),
        "pos": rng.normal(size=(N, 3)).astype(np.float32),
        "view": (3 * rng.normal(size=(N, 3))).astype(np.float32),
        "light": (3 * rng.normal(size=(N, 3))).astype(np.float32),
        "sgs": np.concatenate([rng.normal(size=(8, 3)),
                               rng.uniform(0.5, 20, (8, 1)),
                               rng.uniform(0, 2, (8, 3))], -1
                              ).astype(np.float32),
    }


def _run(fn, args, kw, to):
    return fn(*[to(a) if isinstance(a, np.ndarray) else a for a in args],
              **kw)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


# name, argument keys (strings are inputs, others passed as they are),
# keyword arguments, tolerance
CASES = [
    ("coordinate_system", ["n"], {}, BOUNDED),
    ("to_local", ["wo", "n"], {}, BOUNDED),
    ("to_world", ["wo", "n"], {}, BOUNDED),
    ("square_to_cosine_hemisphere", ["u"], {}, BOUNDED),
    ("sample_uniform_disk_concentric", ["u"], {}, BOUNDED),
    ("sample_uniform_cylinder", ["u"], {}, BOUNDED),
    ("sample_uniform_hemisphere", ["u", "n"], {}, BOUNDED),
    ("eval_uniform_hemisphere", ["wo", "n"], {}, DENSITY),
    ("sample_lambertian_surface", ["u", "n"], {}, BOUNDED),
    ("eval_lambertian_surface", ["wo", "n"], {}, DENSITY),
    ("sample_specular_mirror", [None, "n", "wi"], {}, BOUNDED),
    ("sample_sggx_vndf", ["u", "n", "wi", "alpha"], {}, BOUNDED),
    ("eval_sggx_ndf", ["wo", "n", "alpha"], {}, DENSITY),
    ("eval_sggx_vndf", ["wo", "n", "wi", "alpha"], {}, DENSITY),
    ("sample_diffuse_sggx", ["u", "u2", "n", "wi", "alpha"], {},
     BOUNDED),
    ("eval_diffuse_sggx", ["u", "wi", "n", "wo", "alpha"], {},
     BOUNDED),
    ("sample_specular_sggx", ["u", "n", "wi", "alpha"], {},
     BOUNDED),
    ("eval_specular_sggx", ["wi", "n", "wo", "alpha"], {}, DENSITY),
    ("fresnel_schlick", ["col", "col1"], {}, BOUNDED),
    ("fresnel_schlick", ["col", "col1"], {"f90": 0.7}, BOUNDED),
    ("eval_ggx_ndf", ["alpha", "cos"], {}, DENSITY),
    ("smith_ggx_g1", ["alpha", "cos"], {}, BOUNDED),
    ("smith_ggx_lambda", ["alpha", "cos"], {}, DENSITY),
    ("smith_ggx_g_correlated", ["alpha", "cos", "alpha2"], {}, BOUNDED),
    ("smith_ggx_g1_aniso", ["wo", "alpha", "alpha2"], {}, BOUNDED),
    ("smith_ggx_g1_schlick", ["wo", "alpha"], {}, BOUNDED),
    ("eval_ggx_ndf_aniso", ["wl", "alpha", "alpha2"], {}, DENSITY),
    ("eval_ggx_vndf_local", ["wl", "wl2", "alpha", "alpha2"], {}, DENSITY),
    ("sample_ggx_vndf", ["wl", "alpha", "u"], {}, BOUNDED),
    ("eval_ggx_vndf_pdf", ["wl", "wl2", "alpha"], {}, DENSITY),
    ("lambert", ["n", "wi"], {}, BOUNDED),
    ("frostbite_diffuse", ["n", "wi", "wo", "col1"], {}, BOUNDED),
    ("pbr_specular", ["col", "n", "wo", "wi", "col1"], {}, DENSITY),
    ("phong", ["n", "wo", "wi", 16.0], {}, DENSITY),
    ("pbr_bsdf", ["col", "arm", "pos", "n", "view", "light"], {}, DENSITY),
    ("pbr_bsdf", ["col", "arm", "pos", "n", "view", "light"], {"bsdf": 1},
     DENSITY),
    ("compute_energy", ["sgs"], {}, DENSITY),
    ("eval_sgs", ["sgs", "wo"], {}, DENSITY),
]


def _args(x, keys):
    return [x[k] if isinstance(k, str) else k for k in keys]


@pytest.mark.parametrize("name,keys,kw,tol", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_warp_function_matches_jax(x, name, keys, kw, tol):
    args = _args(x, keys)
    if name == "eval_sgs":  # [K, 7] mixture at [N, 3] directions
        args = [args[0], args[1]]
    want = _run(getattr(jw, name), args, kw, jnp.asarray)
    got = _run(getattr(tw, name), args, kw, torch.from_numpy)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _np(g).shape == _np(w).shape, name
        assert _np(g).dtype == np.float32, name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **tol)


def test_every_warp_function_has_a_case():
    names = {n for n, v in vars(jw).items()
             if callable(v) and not n.startswith("_")
             and getattr(v, "__module__", "") == jw.__name__}
    covered = {c[0] for c in CASES} | {"gen_stratified_samples",
                                       "fibonacci_sphere"}
    assert names == covered, names ^ covered
    assert {n for n in names if not hasattr(tw, n)} == set()


def test_stratified_samples_match_jax():
    """Eval mode is the strata's centres on both sides; in training the
    port's jitter is ``torch.rand((2, B, R, C))`` from the generator,
    laid out as JAX lays out its draws."""
    want = np.asarray(jw.gen_stratified_samples(None, 2, 3, 4,
                                                is_training=False))
    got = tw.gen_stratified_samples(None, 2, 3, 4, is_training=False)
    np.testing.assert_array_equal(got.numpy(), want)
    g = torch.Generator().manual_seed(3)
    got = tw.gen_stratified_samples(g, 2, 3, 4).numpy()
    off = torch.rand((2, 2, 3, 4),
                     generator=torch.Generator().manual_seed(3)).numpy()
    jj = np.arange(4, dtype=np.float32)[None, None, :]
    ii = np.arange(3, dtype=np.float32)[None, :, None]
    want = np.stack([(jj / 4 + off[0] / 4).reshape(-1),
                     (ii / 3 + off[1] / 3).reshape(-1)], -1)
    np.testing.assert_allclose(got, want, **BOUNDED)
    cell = np.floor(got * [4, 3])
    np.testing.assert_array_equal(
        cell, np.floor(np.asarray(jw.gen_stratified_samples(
            jax.random.PRNGKey(0), 2, 3, 4)) * [4, 3]))


def test_fibonacci_sphere_equals_jax():
    np.testing.assert_array_equal(tw.fibonacci_sphere(100),
                                  jw.fibonacci_sphere(100))


@pytest.mark.parametrize("name", ["sample_specular_sggx",
                                  "sample_diffuse_sggx"])
def test_sggx_samples_hold_the_normal_sample_constant(x, name):
    """The SGGX samplers hold the visible normal constant (JAX's
    ``stop_gradient``, the port's ``detach``): no gradient reaches
    ``alpha``; the specular sample's gradient to ``wi`` (through the
    mirror) is JAX's to 1e-4, and the diffuse sample has none."""
    m = 16
    u, u2, n, wi, a = (x[k][:m] for k in ("u", "u2", "n", "wi", "alpha"))
    lead = (u, u2) if name == "sample_diffuse_sggx" else (u,)

    def jloss(wi_, alpha):
        out = getattr(jw, name)(*map(jnp.asarray, lead), jnp.asarray(n),
                                wi_, alpha)
        return jnp.sum(out ** 3)

    want_wi, want_a = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(wi),
                                                     jnp.asarray(a))
    twi = torch.from_numpy(wi).requires_grad_()
    ta = torch.from_numpy(a).requires_grad_()
    out = getattr(tw, name)(*map(torch.from_numpy, lead),
                            torch.from_numpy(n), twi, ta)
    assert np.abs(np.asarray(want_a)).max() == 0.0
    if name == "sample_diffuse_sggx":
        assert not out.requires_grad
        assert np.abs(np.asarray(want_wi)).max() == 0.0
        return
    torch.sum(out ** 3).backward()
    np.testing.assert_allclose(twi.grad.numpy(), np.asarray(want_wi),
                               rtol=0, atol=1e-4)
    assert ta.grad is None


# ----- the goldens of test_bsdf_golden.py on the port ----------------- #

def _g(name):
    return torch.tensor(INPUTS[name], dtype=torch.float32)


def test_bsdf_goldens_on_the_port():
    np.testing.assert_allclose(tw.lambert(_g("nrm"), _g("wi")),
                               GOLDEN["lambert"], rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(
        tw.frostbite_diffuse(_g("nrm"), _g("wi"), _g("wo"), _g("rough")),
        GOLDEN["frostbite"], rtol=2e-5)
    cos = torch.abs(torch.sum(_g("wo") * _g("wi"), -1, keepdim=True))
    np.testing.assert_allclose(tw.fresnel_schlick(_g("col"), cos, f90=1.0),
                               GOLDEN["fresnel"], rtol=2e-5)
    ci = torch.sum(_g("nrm") * _g("wi"), -1)
    co = torch.sum(_g("nrm") * _g("wo"), -1)
    a = _g("alpha")[:, 0]
    np.testing.assert_allclose(tw.eval_ggx_ndf(a, ci), GOLDEN["ndf"],
                               rtol=2e-5)
    np.testing.assert_allclose(tw.smith_ggx_lambda(a, ci), GOLDEN["lam"],
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(tw.smith_ggx_g_correlated(a, ci, co),
                               GOLDEN["gcorr"], rtol=2e-5)
    np.testing.assert_allclose(
        tw.pbr_specular(_g("col"), _g("nrm"), _g("wo"), _g("wi"),
                        _g("alpha")),
        GOLDEN["pbr_specular"], rtol=5e-5, atol=1e-7)
    alpha = _g("alpha").requires_grad_()
    tw.pbr_specular(_g("col"), _g("nrm"), _g("wo"), _g("wi"),
                    alpha).sum().backward()
    np.testing.assert_allclose(alpha.grad, GOLDEN["pbr_specular_dalpha"],
                               rtol=1e-3, atol=1e-6)


# ----- the properties of test_warp_sggx.py on the port ---------------- #

def _rows(v, m):
    v = np.asarray(v, np.float32)
    return torch.from_numpy(np.tile(v / np.linalg.norm(v), (m, 1)))


def _uniform(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        size=shape).astype(np.float32))


def test_sggx_family_properties_on_the_port():
    p = tw.sample_uniform_disk_concentric(_uniform(0, (4096, 2))).numpy()
    r = np.linalg.norm(p, axis=-1)
    assert (r <= 1 + 1e-6).all() and abs(r.mean() - 2 / 3) < 0.02
    assert np.abs(tw.sample_uniform_disk_concentric(
        torch.tensor([[0.5, 0.5]])).numpy()).max() < 1e-6

    n = _rows([0.3, -0.5, 0.8], 2048)
    wo = tw.sample_uniform_hemisphere(_uniform(1, (2048, 2)), n)
    cos = torch.sum(wo * n, -1).numpy()
    assert (cos >= -1e-5).all() and abs(cos.mean() - 0.5) < 0.03
    np.testing.assert_allclose(tw.eval_uniform_hemisphere(wo, n),
                               0.5 / math.pi, atol=1e-7)

    nz = _rows([0, 0, 1], 4096)
    wo = tw.sample_lambertian_surface(_uniform(2, (4096, 2)), nz)
    assert (wo[:, 2] >= -1e-5).all() and abs(wo[:, 2].mean() - 2 / 3) < 0.03
    np.testing.assert_allclose(tw.eval_lambertian_surface(wo, nz),
                               torch.clamp(wo[:, 2], min=0) / math.pi,
                               atol=1e-6)

    n = _rows([0.2, 0.1, 0.97], 2048)
    wi = _rows([0.5, 0.0, 0.87], 2048)
    wm = tw.sample_sggx_vndf(_uniform(3, (2048, 2)), n, wi,
                             torch.full((2048,), 0.4))
    np.testing.assert_allclose(torch.linalg.vector_norm(wm, dim=-1), 1.0,
                               atol=1e-4)
    assert (torch.sum(wm * wi, -1) >= -1e-4).all()

    v = torch.from_numpy(np.random.default_rng(4).normal(
        size=(200000, 3)).astype(np.float32))
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    d = tw.eval_sggx_ndf(v, _rows([0, 0, 1], 200000),
                         torch.full((200000,), 0.5)).numpy()
    c = v[:, 2].numpy()
    np.testing.assert_allclose(
        d, 1 / (math.pi * 0.25 * ((1 - c ** 2) / 0.25 + c ** 2) ** 2),
        rtol=1e-3, atol=1e-5)
    assert abs(4 * math.pi * d.mean() - 2.760) < 0.06

    wo = tw.sample_specular_sggx(_uniform(5, (64, 2)), _rows([0, 0, 1], 64),
                                 _rows([0.3, 0.2, 0.93], 64),
                                 torch.full((64,), 1e-3))
    mirror = tw.sample_specular_mirror(None, _rows([0, 0, 1], 64),
                                       _rows([0.3, 0.2, 0.93], 64))
    mirror = mirror / torch.linalg.vector_norm(mirror, dim=-1, keepdim=True)
    assert (wo - mirror).abs().max() < 0.05

    wi = _rows([0.4, -0.1, 0.9], 1024)
    wo = v[:1024]
    pdf = tw.eval_sggx_vndf(wo, _rows([0, 0, 1], 1024), wi,
                            torch.full((1024,), 0.3))
    assert (pdf >= 0).all() and (pdf[torch.sum(wo * wi, -1) <= 0] == 0).all()

    wh = v[:512].clone()
    wh[:, 2] = wh[:, 2].abs()
    np.testing.assert_allclose(tw.eval_ggx_ndf_aniso(wh, 0.37, 0.37),
                               tw.eval_ggx_ndf(0.37, wh[:, 2]), rtol=2e-3,
                               atol=1e-4)

    wi = _rows([0.1, 0.3, 0.95], 512)
    u1, u2 = _uniform(6, (512, 2)), _uniform(7, (512, 2))
    alpha = torch.full((512,), 0.5)
    wo = tw.sample_diffuse_sggx(u1, u2, _rows([0, 0, 1], 512), wi, alpha)
    np.testing.assert_allclose(torch.linalg.vector_norm(wo, dim=-1), 1.0,
                               atol=1e-4)
    pdf = tw.eval_diffuse_sggx(u1, wi, _rows([0, 0, 1], 512), wo, alpha)
    assert (pdf >= 0).all() and pdf.mean() > 0.05


# ----- brdf-ggx ------------------------------------------------------ #

@pytest.fixture(scope="module")
def brdf_inputs(x):
    m = 256
    rng = np.random.default_rng(1)
    return {"n": x["n"][:m], "wi": x["wi"][:m],
            "alpha_x": x["alpha"][:m],
            "albedo": rng.uniform(size=(m, 3)).astype(np.float32),
            "metallic": rng.uniform(size=(m, 1)).astype(np.float32)}


@pytest.mark.parametrize("min_alpha", [1e-3, 0.2])
def test_brdf_ggx_sample_on_jax_draws_pdf_and_eval_match_jax(brdf_inputs,
                                                            min_alpha):
    cfg = {"name": "brdf-ggx", "min_alpha": min_alpha}
    js, ts = JScatterer(cfg), models.make("brdf-ggx", cfg)
    b = brdf_inputs
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    key = jax.random.PRNGKey(7)
    k1, k2, k3 = jax.random.split(key, 3)
    shape = b["alpha_x"].shape
    draws = [np.array(jax.random.uniform(k1, (*shape, 2))),
             np.array(jax.random.uniform(k2, (*shape, 2))),
             np.array(jax.random.uniform(k3, shape))]
    want = np.asarray(js.sample(key, jb["n"], jb["wi"], jb["alpha_x"],
                                jb["alpha_x"], jb["albedo"], jb["metallic"]))
    got = ts.sample_from_uniforms(*map(torch.from_numpy, draws), tb["n"],
                                  tb["wi"], tb["alpha_x"])
    np.testing.assert_allclose(got.numpy(), want, **BOUNDED)
    wo = torch.from_numpy(want.copy())
    jpdf = js.pdf(jb["n"], jb["wi"], jnp.asarray(want), jb["alpha_x"],
                  jb["alpha_x"], jb["albedo"], jb["metallic"])
    tpdf = ts.pdf(tb["n"], tb["wi"], wo, tb["alpha_x"])
    assert tpdf.shape == (256, 1)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), **DENSITY)
    jd, jsp = js.eval(jb["wi"], jb["n"], jnp.asarray(want), jb["alpha_x"],
                      jb["alpha_x"], jb["albedo"], jb["metallic"])
    td, tsp = ts.eval(tb["wi"], tb["n"], wo, tb["alpha_x"],
                      albedo=tb["albedo"], metallic=tb["metallic"])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **BOUNDED)
    np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp), **DENSITY)
    # the generator wrapper draws the three roles in order
    g = torch.Generator().manual_seed(11)
    u = ts.draw_uniforms(shape, torch.Generator().manual_seed(11))
    np.testing.assert_array_equal(
        ts.sample(g, tb["n"], tb["wi"], tb["alpha_x"]).numpy(),
        ts.sample_from_uniforms(*u, tb["n"], tb["wi"],
                                tb["alpha_x"]).numpy())
    assert list(ts.parameters()) == []


# ----- float32 conditioning of the samplers ----------------------------- #

# the bounds chip_smoke.py holds the card's sampled directions to (its
# DIR_TOL and DIR_SHARE), at one 800^2 view's size
DIR_TOL, DIR_SHARE, VIEW = 1e-3, 5e-3, 640000
SAMPLERS = [("square_to_cosine_hemisphere", ["u"]),
            ("sample_uniform_disk_concentric", ["u"]),
            ("sample_uniform_cylinder", ["u"]),
            ("sample_uniform_hemisphere", ["u", "n"]),
            ("sample_lambertian_surface", ["u", "n"]),
            ("sample_specular_mirror", [None, "n", "wi"]),
            ("sample_sggx_vndf", ["u", "n", "wi", "alpha"]),
            ("sample_diffuse_sggx", ["u", "u2", "n", "wi", "alpha"]),
            ("sample_specular_sggx", ["u", "n", "wi", "alpha"]),
            ("sample_ggx_vndf", ["wl", "alpha", "u"])]


@pytest.fixture(scope="module")
def view_inputs():
    rng = np.random.default_rng(16)
    wi, n = _unit(rng, VIEW), _unit(rng, VIEW)
    wi[: VIEW // 2] *= np.sign(np.sum(wi[: VIEW // 2] * n[: VIEW // 2],
                                      -1))[:, None]
    x = {"u": rng.uniform(size=(VIEW, 2)), "u2": rng.uniform(size=(VIEW, 2)),
         "n": n, "wi": wi, "wl": _upper(rng, VIEW),
         "alpha": rng.uniform(0.05, 1, VIEW)}
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in x.items()}


@pytest.mark.parametrize("name,keys", SAMPLERS, ids=[s[0] for s in SAMPLERS])
def test_float32_samplers_stay_within_the_card_bounds(view_inputs, name,
                                                      keys):
    """Square roots of differences near 0 amplify float32 rounding: each
    sampler's float32 directions stay within DIR_TOL of the same maths in
    float64, and within 1e-5 on all but DIR_SHARE of them (measured on
    these inputs: the SGGX samplers reach 3.2e-4, 0.19 % beyond 1e-5;
    the others 1.2e-4 and 0.005 % at most)."""
    fn = getattr(tw, name)
    f32 = fn(*[view_inputs[k] if k else None for k in keys])
    f64 = fn(*[view_inputs[k].double() if k else None for k in keys])
    err = (f32.double() - f64).abs().reshape(VIEW, -1).amax(-1)
    assert float(err.max()) <= DIR_TOL, float(err.max())
    assert float((err > 1e-5).double().mean()) <= DIR_SHARE
