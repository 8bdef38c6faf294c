"""Shading ``volume-pbr`` from given secondary directions
(``measure.fixed_directions``), as ``chip_smoke.py`` phase 15b shades
its CPU chunk from the card's directions, against the JAX package's
``volume-pbr`` with its scatterer's ``sample`` made to return the same
directions.  Outputs divide by the pdf, so they are held as
``tests/test_torch_texture_heads.py`` holds the head on JAX's draws:
rtol 1e-5 with an absolute floor of 1e-5 of the largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu import models as jmodels
from rise_sdf_tpu.models.light import EnvLightMipCube as JLight
from rise_sdf_tpu_torch import models
from rise_sdf_tpu_torch.measure import fixed_directions
from rise_sdf_tpu_torch.models.light import EnvLightMipCube

LIGHT = {"envlight_config": {"hdr_filepath": None, "clamp": True,
                             "nmf_format": False, "scale": 0.5, "bias": 0.25,
                             "base_res": 32}}
CFG = {"name": "volume-pbr",
       "scatterer": {"name": "brdf-ggx", "min_alpha": 1e-3}}
N = 300


def _unit(rng, n):
    d = rng.standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    """Inputs of one chunk of shading points (normals towards the camera,
    as at a surface), the two sides' lights on one base, and the
    secondary directions: mostly in the normal's hemisphere, some below
    it (pdf 0 there)."""
    rng = np.random.default_rng(17)
    x = {"pos": rng.uniform(-1, 1, (N, 3)).astype(np.float32),
         "dirs": _unit(rng, N), "normals": _unit(rng, N),
         "albedo": rng.uniform(size=(N, 3)).astype(np.float32),
         "rough": rng.uniform(0.05, 1, (N, 1)).astype(np.float32),
         "metal": rng.uniform(size=(N, 1)).astype(np.float32)}
    flip = np.sum(x["normals"] * x["dirs"], -1) > 0
    x["normals"][flip] *= -1
    d = _unit(rng, N)
    up = np.sum(d * x["normals"], -1) < 0
    up[: N // 10] = False
    d[up] *= -1
    x["secondary"] = d
    base = rng.uniform(0.05, 1.5, (6, 32, 32, 3)).astype(np.float32)
    tl = EnvLightMipCube(LIGHT)
    tl.load_state_dict({"base": torch.from_numpy(base)})
    return x, (JLight(LIGHT), {"base": jnp.asarray(base)}), tl


def _indirect_torch(seen):
    def fn(o, d):
        seen.append(d)
        tr = torch.sigmoid(torch.sum(o * d, -1, keepdim=True))
        return tr, 0.5 + 0.5 * torch.sin(3.0 * o + d)
    return fn


def _indirect_jax(o, d):
    tr = 1.0 / (1.0 + jnp.exp(-jnp.sum(o * d, -1, keepdims=True)))
    return tr, 0.5 + 0.5 * jnp.sin(3.0 * o + d)


def _args(x):
    return [torch.from_numpy(x[k]) for k in ("pos", "dirs", "normals",
                                             "albedo", "rough", "metal")]


@pytest.mark.parametrize("gi", [True, False])
def test_shading_from_given_directions_matches_jax(scene, gi):
    """Both sides shade from the same directions: the port's
    ``compute_indirect`` receives them bit for bit, and every output
    equals JAX's."""
    x, (jl, lparams), tl = scene
    cfg = dict(CFG, global_illumination=gi)
    th, jh = models.make("volume-pbr", cfg), jmodels.make("volume-pbr", cfg)
    d = x["secondary"]
    jh.scatterer.sample = lambda rng, **kw: jnp.asarray(d)
    want = jh.apply({}, *(jnp.asarray(x[k]) for k in (
        "pos", "dirs", "normals", "albedo", "rough", "metal")),
        _indirect_jax, jl, lparams, None)
    seen = []
    uniforms = th.scatterer.draw_uniforms((N,), torch.Generator()
                                          .manual_seed(1))
    with torch.no_grad(), fixed_directions(th.scatterer,
                                           torch.from_numpy(d)):
        got = th(*_args(x), _indirect_torch(seen), tl, uniforms=uniforms)
    assert len(seen) == 1 and torch.equal(seen[0], torch.from_numpy(d))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_fixing_the_sampled_directions_changes_nothing(scene):
    """Shading from the directions the scatterer would sample is
    bit-equal to shading that samples them."""
    x, _, tl = scene
    th = models.make("volume-pbr", CFG)
    sc = th.scatterer
    u = sc.draw_uniforms((N,), torch.Generator().manual_seed(2))
    args = _args(x)
    with torch.no_grad():
        a = th(*args, _indirect_torch([]), tl, uniforms=u)
        d = sc.sample_from_uniforms(*u, args[2], -args[1], args[4][:, 0])
        with fixed_directions(sc, d):
            b = th(*args, _indirect_torch([]), tl, uniforms=u)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_fixed_directions_restore_the_sampler_and_check_shapes(scene):
    x, _, tl = scene
    th = models.make("volume-pbr", CFG)
    sc = th.scatterer
    u = sc.draw_uniforms((N,), torch.Generator().manual_seed(3))
    args = _args(x)
    with pytest.raises(ValueError):
        with torch.no_grad(), fixed_directions(sc, torch.zeros((N - 1, 3))):
            th(*args, _indirect_torch([]), tl, uniforms=u)
    assert "sample_from_uniforms" not in vars(sc)
    with pytest.raises(RuntimeError):
        with fixed_directions(sc, torch.zeros((N, 3))):
            raise RuntimeError("inside the block")
    assert "sample_from_uniforms" not in vars(sc)
    seen = []
    with torch.no_grad():
        th(*args, _indirect_torch(seen), tl, uniforms=u)
    assert torch.equal(seen[0], sc.sample_from_uniforms(
        *u, args[2], -args[1], args[4][:, 0]))
