"""Port parity: the appearance heads ``volume-color``,
``volume-split-sum-mip-occ`` and ``volume-pbr`` against the JAX
package's, on the CPU; NeuS with ``volume-color`` for one Adam step; and
both flagships refusing ``volume-split-sum-mip-occ``.

Each head takes the JAX init's parameters (plus seeded noise) through
``bridge``, whose round trip is bit-equal, and the same numpy inputs
from a seed.  Tolerances: head outputs max abs 1e-5 (rel 1e-5); the
parameter gradients of a fixed random weighting of every output, 1e-4
of each tensor's largest entry (sums over samples in other orders).
``volume-pbr`` takes JAX's own draws of its scatterer (the three
uniforms of the keys its ``sample`` splits) and a ``compute_indirect``
written once per side with the same arithmetic; its outputs divide by
the sampled pdf, so they are held relatively, rtol 1e-5 with an
absolute floor of 1e-5 of the largest entry.  The NeuS step is held as
``tests/test_torch_neus.py`` holds the radiance head's: loss to rtol
1e-4, gradients to 1e-3 of their largest entry, parameters after one
Adam step to 1e-4 where the gradient is above its rounding noise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import models as jmodels
from rise_sdf_tpu import presets as jpresets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.models.light import EnvLightMipCube as JLight
from rise_sdf_tpu_torch import bench, bridge, datasets, models, presets, \
    systems
from rise_sdf_tpu_torch.models.light import EnvLightMipCube
from rise_sdf_tpu_torch.systems.optim import make_optimizer

LIGHT = {"envlight_config": {"hdr_filepath": None, "clamp": True,
                             "nmf_format": False, "scale": 0.5, "bias": 0.25,
                             "base_res": 32}}
TOL = dict(rtol=1e-5, atol=1e-5)
N = 200


def _t(a):
    return torch.from_numpy(np.array(a))


def _dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _grad_close(got, want, name, frac=1e-4):
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=frac * max(float(np.abs(want).max()),
                                               1e-12), err_msg=name)


def _split_texture_cfg(name):
    cfg = presets.tiny_split_config()["model"]["texture"]
    cfg = {k: v for k, v in cfg.items() if k != "spec_mlp_network_config"} \
        if name == "volume-split-sum-mip-occ" else dict(cfg)
    cfg["name"] = name
    return cfg


def _pair(name, cfg, seed):
    """(JAX head, its params with seeded noise, the port's head loaded
    with them); the bridge round trip checked bit for bit."""
    jh = jmodels.make(name, cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32),
        jh.init(jax.random.PRNGKey(seed)))
    th = models.make(name, cfg)
    flat = bridge.flatten_params(params, "params")
    th.load_state_dict(bridge.from_jax_params(flat), strict=True)
    back = bridge.to_jax_params(th.state_dict())
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    return jh, params, th


@pytest.fixture(scope="module")
def lights():
    base = np.random.default_rng(3).uniform(0.05, 1.5, (6, 32, 32, 3)
                                            ).astype(np.float32)
    tl = EnvLightMipCube(LIGHT)
    tl.load_state_dict({"base": _t(base)})
    return JLight(LIGHT), {"base": jnp.asarray(base)}, tl


def _weights(out, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(np.shape(v)).astype(np.float32)
            for k, v in out.items()}


def _check(jfn, params, tfn, th, seed):
    """Forward of both sides, then the gradients of the weighted sum of
    every output to every parameter."""
    want = jfn(params)
    got = tfn()
    want_d = want if isinstance(want, dict) else {"out": want}
    got_d = got if isinstance(got, dict) else {"out": got}
    assert sorted(got_d) == sorted(want_d)
    for k in want_d:
        np.testing.assert_allclose(got_d[k].detach().numpy(),
                                   np.asarray(want_d[k]), err_msg=k, **TOL)
    w = _weights(want_d, seed)

    def jloss(p):
        out = jfn(p)
        out = out if isinstance(out, dict) else {"out": out}
        return sum(jnp.sum(out[k] * w[k]) for k in out)

    gj = bridge.flatten_params(jax.grad(jloss)(params), "params")
    th.zero_grad(set_to_none=True)
    sum(torch.sum(got_d[k] * _t(w[k])) for k in got_d).backward()
    gt = {bridge.jax_path(k): p.grad for k, p in th.named_parameters()}
    assert sorted(gt) == sorted(gj)
    for k in gj:
        g = np.zeros_like(gj[k]) if gt[k] is None else gt[k].numpy()
        _grad_close(g, gj[k], k)
    return want_d


def test_volume_color_forward_and_grads_match_jax():
    cfg = {"name": "volume-color", "input_feature_dim": 13,
           "mlp_network_config": presets.tiny_mlp(2, 16),
           "color_activation": "sigmoid"}
    jh, params, th = _pair("volume-color", cfg, 0)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((N, 13)).astype(np.float32)
    dirs, normals = _dirs(N, 2), _dirs(N, 3)
    _check(lambda p: jh.apply(p, jnp.asarray(feats), jnp.asarray(dirs),
                              jnp.asarray(normals)),
           params, lambda: th(_t(feats), _t(dirs), _t(normals)), th, 4)


def test_volume_split_sum_mip_forward_and_grads_match_jax(lights):
    jl, lparams, tl = lights
    name = "volume-split-sum-mip-occ"
    jh, params, th = _pair(name, _split_texture_cfg(name), 5)
    assert th.supports_multi_emitter is False
    assert jh.supports_multi_emitter is False
    assert sorted(n for n, _ in th.named_children()) == [
        "albedo", "dir_encoding", "metallic", "roughness", "secondary",
        "xyz_encoding"]
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((N, 13)).astype(np.float32)
    dirs, normals = _dirs(N, 7), _dirs(N, 8)
    pos = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    jm = jl.build_mips(lparams)
    with torch.no_grad():
        tm = tl.build_mips()
    want = _check(
        lambda p: jh.apply(p, jnp.asarray(feats), jnp.asarray(dirs),
                           jnp.asarray(normals), jnp.asarray(pos), emitter=jl,
                           mips=jm, step=20),
        params,
        lambda: th.apply(_t(feats), _t(dirs), _t(normals), _t(pos),
                         emitter=tl, mips=tm, step=20), th, 9)
    # the caveat copied from the reference: no NN radiance channels
    assert not {"diff_rgb", "spec_rgb", "blend"} & set(want)
    _check(lambda p: jh.secondary_shading(p, jnp.asarray(feats),
                                          jnp.asarray(dirs),
                                          jnp.asarray(normals), step=20),
           params, lambda: th.secondary_shading(_t(feats), _t(dirs),
                                                _t(normals), step=20),
           th, 10)
    _check(lambda p: jh.secondary_shading_pbr(
        p, jnp.asarray(feats), jnp.asarray(dirs), jnp.asarray(normals),
        jnp.asarray(pos), jl, jm, step=20), params,
        lambda: th.secondary_shading_pbr(_t(feats), _t(dirs), _t(normals),
                                         _t(pos), tl, tm, step=20), th, 11)


def _indirect_jax(o, d):
    tr = jax.nn.sigmoid(jnp.sum(o * d, -1, keepdims=True))
    return tr, 0.5 + 0.5 * jnp.sin(3.0 * o + d)


def _indirect_torch(o, d):
    tr = torch.sigmoid(torch.sum(o * d, -1, keepdim=True))
    return tr, 0.5 + 0.5 * torch.sin(3.0 * o + d)


@pytest.mark.parametrize("gi", [True, False])
def test_volume_pbr_on_jax_draws_matches_jax(lights, gi):
    """Forward on JAX's draws, then the gradients to the material, the
    positions, the normals and the emitter's base (the sampled direction
    held constant on both sides)."""
    jl, lparams, tl = lights
    cfg = {"name": "volume-pbr", "global_illumination": gi,
           "scatterer": {"name": "brdf-ggx", "min_alpha": 1e-3}}
    jh = jmodels.make("volume-pbr", cfg)
    th = models.make("volume-pbr", cfg)
    assert jh.init(jax.random.PRNGKey(0)) == {"scatterer": {}}
    assert list(th.parameters()) == []
    rng = np.random.default_rng(12)
    x = {"pos": rng.uniform(-1, 1, (N, 3)).astype(np.float32),
         "dirs": _dirs(N, 13), "normals": _dirs(N, 14),
         "albedo": rng.uniform(size=(N, 3)).astype(np.float32),
         "rough": rng.uniform(0.05, 1, (N, 1)).astype(np.float32),
         "metal": rng.uniform(size=(N, 1)).astype(np.float32)}
    # normals towards the camera on most samples, as at a surface
    flip = np.sum(x["normals"] * x["dirs"], -1) > 0
    flip[150:] = False
    x["normals"][flip] *= -1
    key = jax.random.PRNGKey(21)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (np.array(jax.random.uniform(k1, (N, 2))),
             np.array(jax.random.uniform(k2, (N, 2))),
             np.array(jax.random.uniform(k3, (N,))))
    names = ["pos", "normals", "albedo", "rough", "metal"]

    def jrun(pos, normals, albedo, rough, metal, base):
        return jh.apply({}, pos, jnp.asarray(x["dirs"]), normals, albedo,
                        rough, metal, _indirect_jax, jl, {"base": base}, key)

    jin = [jnp.asarray(x[k]) for k in names] + [lparams["base"]]
    want = jrun(*jin)
    tin = [_t(x[k]).requires_grad_() for k in names]
    tl.zero_grad(set_to_none=True)
    got = th(tin[0], _t(x["dirs"]), tin[1], tin[2], tin[3], tin[4],
             _indirect_torch, tl, uniforms=tuple(map(_t, draws)))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    wts = _weights(want, 15)

    def jloss(*a):
        out = jrun(*a)
        return sum(jnp.sum(out[k] * wts[k]) for k in out)

    gj = jax.grad(jloss, argnums=tuple(range(6)))(*jin)
    sum(torch.sum(got[k] * _t(wts[k])) for k in got).backward()
    for name, g, t in zip(names + ["base"], gj, tin + [tl.base]):
        _grad_close(t.grad.numpy(), np.asarray(g), name, frac=1e-4)
    # the generator path draws the scatterer's uniforms in their order
    g1, g2 = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
    with torch.no_grad():
        a = th(*[_t(x[k]) for k in ("pos", "dirs", "normals", "albedo",
                                    "rough", "metal")], _indirect_torch, tl,
               generator=g1)
        u = th.scatterer.draw_uniforms((N,), g2)
        b = th(*[_t(x[k]) for k in ("pos", "dirs", "normals", "albedo",
                                    "rough", "metal")], _indirect_torch, tl,
               uniforms=u)
    np.testing.assert_array_equal(a["rgb_phys"].numpy(),
                                  b["rgb_phys"].numpy())


# --------------------------------------------------------------------- #
# NeuS with volume-color: one Adam step
# --------------------------------------------------------------------- #

def _color_texture():
    return {"name": "volume-color", "input_feature_dim": 13,
            "mlp_network_config": presets.tiny_mlp(2, 16),
            "color_activation": "sigmoid"}


def _shell_grid(res=32, radius=1.5):
    c = (np.arange(res) + 0.5) / res * 2 * radius - radius
    p = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    return np.abs(np.linalg.norm(p, axis=-1) - 0.5) < 0.35


def test_neus_with_volume_color_one_adam_step_matches_jax(tmp_path):
    jcfg = jpresets.tiny_neus_config()
    jcfg["model"]["texture"] = _color_texture()
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                         save_dir=str(tmp_path / "jax"))
    jstate = jsys.init_state(0)
    path = jsys.save_checkpoint(jstate, str(tmp_path / "jax.ckpt.npz"))
    cfg = presets.tiny_neus_config()
    cfg["model"]["texture"] = _color_texture()
    tsys = systems.make(cfg["system"]["name"], cfg,
                        datasets.make(cfg["dataset"]["name"], cfg["dataset"]),
                        save_dir=str(tmp_path / "torch"), device="cpu")
    tsys.init_state(1)
    tstate = tsys.load_checkpoint(path)
    tsys.optimizer, tsys.scheduler = make_optimizer(tsys.config["system"],
                                                    tsys.model)
    grid = _shell_grid()
    tstate["occ_binary"] = torch.from_numpy(grid)
    data = tsys.device_data(tsys.datamodule.train())
    b = {k: v.numpy() for k, v in tsys.sample_batch(
        torch.Generator().manual_seed(4), data).items()}
    batch = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        return jsys.forward_loss(p, batch, jnp.asarray(grid), 0, None, None,
                                 jsys.capacity)

    (loss_j, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate["params"])
    tsys.model.zero_grad(set_to_none=True)
    loss_t, _ = tsys.forward_loss({k: _t(v) for k, v in b.items()},
                                  torch.from_numpy(grid), 0)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-4)
    gj = bridge.flatten_params(grads)
    gt = {bridge.jax_path(k): p.grad.numpy()
          for k, p in tsys.model.named_parameters()}
    assert sorted(gt) == sorted(gj)
    assert any(k.startswith("params/texture/mlp/") for k in gj)
    for k in gj:
        np.testing.assert_allclose(gt[k], gj[k], rtol=1e-3,
                                   atol=1e-3 * float(np.abs(gj[k]).max()),
                                   err_msg=k)
    opt_state = jsys.tx.init(jstate["params"])
    updates, _ = jsys.tx.update(grads, opt_state, jstate["params"])
    want = bridge.flatten_params(optax.apply_updates(jstate["params"],
                                                     updates))
    aux = tsys.train_step(tsys.load_checkpoint(path) | {
        "occ_binary": torch.from_numpy(grid)},
        {k: _t(v) for k, v in b.items()}, generator=None)
    np.testing.assert_allclose(float(aux["loss"]), float(loss_j), rtol=1e-4)
    got = bridge.to_jax_params(tsys.model.state_dict())
    compared = 0
    for k in want:
        sel = np.abs(gj[k]) > 1e-6
        compared += int(sel.sum())
        np.testing.assert_allclose(got[k][sel], want[k][sel], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert compared > 500


def test_neus_sphere_color_full_preset():
    """The card's phase-15a preset: ``neus_sphere_full`` with the
    radiance head's MLP behind a ``volume-color`` head on the 48
    geometry features; the JAX package's NeuS model builds from it."""
    cfg = presets.neus_sphere_color_full()
    full = presets.neus_sphere_full()
    tex = cfg["model"]["texture"]
    assert tex["name"] == "volume-color" and tex["input_feature_dim"] == 48
    assert tex["mlp_network_config"] == full["model"]["texture"][
        "mlp_network_config"]
    assert {k: v for k, v in cfg["model"].items() if k != "texture"} == \
        {k: v for k, v in full["model"].items() if k != "texture"}
    jm = jmodels.make("neus", cfg["model"])
    assert type(jm.texture).__name__ == "VolumeColor"


# --------------------------------------------------------------------- #
# the flagships refuse volume-split-sum-mip-occ
# --------------------------------------------------------------------- #

def test_both_flagships_refuse_the_split_sum_mip_head():
    """The JAX flagship's forward reads ``diff_rgb`` from the texture's
    output (``rise_sdf_tpu/models/split_mixed_occ.py:595-601``), which
    ``VolumeSplitSumMip.apply`` does not give: both forwards raise
    ``KeyError`` at stage 1."""
    name = "volume-split-sum-mip-occ"
    cfg = presets.tiny_split_config()["model"]
    cfg["texture"] = _split_texture_cfg(name)
    jcfg = jpresets.tiny_split_config()
    jcfg["model"]["texture"] = _split_texture_cfg(name)
    jm = jmodels.make(jcfg.model.name, jcfg.model)
    params = jm.init(jax.random.PRNGKey(0))
    tm = models.make(cfg["name"], cfg)
    tm.load_state_dict(bridge.from_jax_params(bridge.flatten_params(params)),
                       strict=True)
    rays = bench.image_rays(4, "cpu")
    occ = bench.solid_occupancy(tm, "cpu")
    step = jcfg.model.split_sum_kick_in_step + 10
    with pytest.raises(KeyError, match="diff_rgb"):
        jm.forward(params, jnp.asarray(rays.numpy()),
                   occ_binary=jnp.asarray(occ.numpy()),
                   mips=jm.emitter.build_mips(params["emitter"]),
                   step=jnp.asarray(step, jnp.int32), rng=None, stage=1,
                   train=False, capacity=16 * 64,
                   background_color=jnp.ones((3,)))
    with torch.no_grad(), pytest.raises(KeyError, match="diff_rgb"):
        tm(rays, occ_binary=occ, mips=tm.emitter.build_mips(), step=step,
           stage=1, capacity=16 * 64, background_color=torch.ones(3))
