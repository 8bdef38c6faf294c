"""Port parity: the emitter's Monte-Carlo half (``EnvLightMipCube``'s
``eval_base``, ``update_pdf``, ``sample``, ``sample_stratified`` and
``pdf``) against the JAX package's, on the CPU.

The base cubemap (32^2) is drawn with numpy from a seed and loaded into
both emitters.  The samplers take JAX's own draws (``jax.random.uniform``
on the keys that JAX's ``sample`` and ``sample_stratified`` split).
Tolerances: lookups and directions max abs 1e-5; the pdf and its CDFs
relative 1e-5 (absolute floor 1e-7); inverse pdfs relative 1e-5.  The
port repeats the consistency check of ``tests/test_light.py``: a Monte-
Carlo estimate of the brightest channel's integral within 10 % of the
direct sum.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu.models.light import EnvLightMipCube as JLight
from rise_sdf_tpu.ops.cubemap import cubemap_to_latlong as jlatlong
from rise_sdf_tpu_torch.models.light import EnvLightMipCube

LIGHT = {"envlight_config": {"hdr_filepath": None, "clamp": True,
                             "nmf_format": False, "scale": 0.5, "bias": 0.25,
                             "base_res": 32}}
BOUNDED = dict(rtol=0, atol=1e-5)
DENSITY = dict(rtol=1e-5, atol=1e-7)
RES = (64, 128)


@pytest.fixture(scope="module")
def pair():
    base = np.random.default_rng(0).uniform(0.05, 2.0, (6, 32, 32, 3)
                                            ).astype(np.float32)
    base[2, 8:20, 10:22] *= 8.0  # a bright patch, so the CDF has a peak
    tl = EnvLightMipCube(LIGHT)
    tl.load_state_dict({"base": torch.from_numpy(base)})
    return JLight(LIGHT), {"base": jnp.asarray(base)}, tl


def _dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_eval_base_matches_jax(pair):
    jl, params, tl = pair
    d = _dirs(1000, 1)
    want = jl.eval_base(params, jnp.asarray(d))
    got = tl.eval_base(torch.from_numpy(d))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **BOUNDED)
    other = params["base"][::-1] * 0.5
    got = tl.eval_base(torch.from_numpy(d),
                       torch.from_numpy(np.array(other)))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jl.eval_base({"base": other}, jnp.asarray(d))), **BOUNDED)


def test_update_pdf_matches_jax(pair):
    jl, params, tl = pair
    want = jl.update_pdf(params, res=RES)
    with torch.no_grad():
        got = tl.update_pdf(res=RES)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **DENSITY)


def _jax_sample_draws(key, n):
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.uniform(k1, (n,))),
            np.array(jax.random.uniform(k2, (n,))))


def test_sample_and_pdf_on_jax_draws_match_jax(pair):
    jl, params, tl = pair
    jst = jl.update_pdf(params, res=RES)
    with torch.no_grad():
        tst = tl.update_pdf(res=RES)
    key, n = jax.random.PRNGKey(5), 4096
    want = np.asarray(jl.sample(jst, key, n))
    u = tuple(map(torch.from_numpy, _jax_sample_draws(key, n)))
    got = tl.sample(tst, uniforms=u)
    np.testing.assert_allclose(got.numpy(), want, **BOUNDED)
    # the same state on both sides: the same directions
    jstate = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    np.testing.assert_allclose(tl.sample(jstate, uniforms=u).numpy(), want,
                               **BOUNDED)
    d = _dirs(4096, 6)
    np.testing.assert_allclose(
        tl.pdf(tst, torch.from_numpy(d)).numpy(),
        np.asarray(jl.pdf(jst, jnp.asarray(d))), **DENSITY)
    np.testing.assert_allclose(
        tl.pdf(tst, torch.from_numpy(want.copy())).numpy(),
        np.asarray(jl.pdf(jst, jnp.asarray(want))), **DENSITY)
    # the generator draws the two uniforms in order
    g = torch.Generator().manual_seed(9)
    ref = torch.Generator().manual_seed(9)
    u = (torch.rand(64, generator=ref), torch.rand(64, generator=ref))
    np.testing.assert_array_equal(tl.sample(tst, 64, generator=g).numpy(),
                                  tl.sample(tst, uniforms=u).numpy())


@pytest.mark.parametrize("jitter", [True, False])
def test_sample_stratified_matches_jax(pair, jitter):
    jl, _, tl = pair
    key, b, r, c = jax.random.PRNGKey(3), 2, 8, 16
    wd, wi = jl.sample_stratified(key, b, r, c, jitter=jitter)
    k1, k2 = jax.random.split(key)
    u = (torch.from_numpy(np.array(jax.random.uniform(k1, (b, r, c)))),
         torch.from_numpy(np.array(jax.random.uniform(k2, (b, r, c)))))
    gd, gi = tl.sample_stratified(b, r, c, jitter=jitter, uniforms=u)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **BOUNDED)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-5)
    assert gd.shape == (b * r * c, 3) and gi.shape == (b * r * c, 1)
    if jitter:
        g, ref = torch.Generator().manual_seed(4), \
            torch.Generator().manual_seed(4)
        u = (torch.rand((b, r, c), generator=ref),
             torch.rand((b, r, c), generator=ref))
        np.testing.assert_array_equal(
            tl.sample_stratified(b, r, c, generator=g)[0].numpy(),
            tl.sample_stratified(b, r, c, uniforms=u)[0].numpy())
    else:
        np.testing.assert_array_equal(
            tl.sample_stratified(b, r, c, jitter=False)[0].numpy(),
            tl.sample_stratified(b, r, c)[0].numpy())


def test_importance_sampling_consistency_on_the_port():
    """``tests/test_light.py``'s check on the port: the Monte-Carlo
    estimate of the brightest channel's integral over the sphere, with
    20,000 importance samples, within 10 % of the direct sum over the
    lat-long image; and the mean of 1 / pdf over the draws within 5 %
    of 4 pi."""
    tl = EnvLightMipCube(LIGHT)
    with torch.no_grad():
        tl.base.copy_(torch.rand((6, 32, 32, 3),
                                 generator=torch.Generator().manual_seed(4))
                      + 0.1)
        st = tl.update_pdf(res=RES)
        dirs = tl.sample(st, 20000, generator=torch.Generator().manual_seed(5))
        pdf = tl.pdf(st, dirs)
        vals = tl.eval_base(dirs)
    est = float(torch.mean(vals.amax(-1) / torch.clamp(pdf, min=1e-9)))
    img = np.asarray(jlatlong(jnp.asarray(tl.base.detach().numpy()), RES))
    y = (np.arange(RES[0]) + 0.5) / RES[0]
    ref = float((img.max(-1) * np.sin(y * np.pi)[:, None]).sum()
                * (np.pi / RES[0]) * (2 * np.pi / RES[1]))
    assert abs(est - ref) / ref < 0.1, (est, ref)
    inv = float(torch.mean(1.0 / pdf))
    assert abs(inv - 4 * math.pi) / (4 * math.pi) < 0.05, inv
