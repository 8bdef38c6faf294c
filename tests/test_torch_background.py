"""Port parity for NeuS on an unbounded scene: the learned background
(``contract_to_unisphere``, ``VolumeDensity``, ``forward_bg`` and the
NeuS forward composited over it), the distortion loss, cone-angle
marching, ``sdf_activation`` and the sphere init's ``inside_outside``,
and the ``neus_colmap`` preset.

The JAX side runs ``rise_sdf_tpu.presets.tiny_neus_config()`` with the
tiny background merged in (the port's ``TINY_BACKGROUND``); parameters
reach the port through a JAX checkpoint file (``bridge.py``).  Rays are
made from a numpy seed and marched unstratified on both sides.
Tolerances, as ``tests/test_torch_neus.py`` states them: render outputs
1e-4, the loss rtol 1e-4, each gradient 1e-3 of its tensor's largest
entry (both sides' float32 transmittance scans over the whole buffer).
The background's dense per-ray scan has no such error: its outputs are
held at 1e-5."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import models as jmodels
from rise_sdf_tpu import presets as jpresets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.models.geometry import \
    contract_to_unisphere as jcontract
from rise_sdf_tpu.nn import MLP as JMLP
from rise_sdf_tpu.ops import march as jmarch
from rise_sdf_tpu.ops.volrend import distortion_loss as jdistortion
from rise_sdf_tpu_torch import bridge, datasets, models, presets, systems
from rise_sdf_tpu_torch.models.geometry import contract_to_unisphere
from rise_sdf_tpu_torch.nn import MLP
from rise_sdf_tpu_torch.ops import march, volrend
from rise_sdf_tpu_torch.parallel import sharding

FWD = dict(rtol=1e-4, atol=1e-4)
BG = dict(rtol=1e-5, atol=1e-5)
LAMBDA_DISTORTION = 0.01


def _assert_grad_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * float(np.abs(want).max()),
                               err_msg=name)


def jax_config(**model):
    """The JAX tiny NeuS config with the tiny background merged in."""
    cfg = jpresets.tiny_neus_config()
    cfg.model.merge(dict(presets.TINY_BACKGROUND, **model))
    cfg.system.optimizer.params.merge(presets.BACKGROUND_LR)
    return cfg


def port_config(**model):
    cfg = presets.tiny_neus_colmap_config()
    cfg["model"].update(model)
    return cfg


def _rays(n=48, seed=0, dist=3.0):
    """Rays from a sphere of radius ``dist`` towards the origin, some
    passing beside the foreground box."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = dist * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o / dist + 0.6 * rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], -1).astype(np.float32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX system with fresh params and the port's with the same params,
    loaded through a JAX checkpoint; both with the distortion loss on."""
    tmp = str(tmp_path_factory.mktemp("bg"))
    jcfg = jax_config()
    jcfg.system.loss.lambda_distortion = LAMBDA_DISTORTION
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                         save_dir=os.path.join(tmp, "jax"))
    jstate = jsys.init_state(0)
    path = jsys.save_checkpoint(jstate, os.path.join(tmp, "jax.ckpt.npz"))
    cfg = port_config()
    cfg["system"]["loss"]["lambda_distortion"] = LAMBDA_DISTORTION
    tsys = systems.make(cfg["system"]["name"], cfg,
                        datasets.make(cfg["dataset"]["name"], cfg["dataset"]),
                        save_dir=os.path.join(tmp, "torch"), device="cpu")
    tsys.init_state(1)
    tstate = tsys.load_checkpoint(path)
    return jsys, jstate, tsys, tstate, path, tmp


def test_tiny_config_matches_jax():
    assert port_config() == jax_config()


def test_neus_colmap_preset_spelled_out():
    """The preset against its dict written out: ``neus_blender``'s
    foreground at radius 0.5 and instant-nsr-pl's neus-colmap members."""
    got = presets.neus_colmap()
    mlp = {"otype": "VanillaMLP", "activation": "ReLU",
           "output_activation": "none"}
    sh4 = {"otype": "SphericalHarmonics", "degree": 4}
    want_model = {
        "name": "neus", "radius": 0.5, "num_samples_per_ray": 1024,
        "train_num_rays": 4096, "max_train_num_rays": 4096,
        "train_sample_capacity": 1048576, "eval_samples_per_ray": 128,
        "grid_prune": True, "grid_prune_occ_thre": 0.001,
        "dynamic_ray_sampling": False, "batch_image_sampling": True,
        "randomized": True, "ray_chunk": 4096, "cos_anneal_end": 20000,
        "learned_background": True, "background_color": "random",
        "num_samples_per_ray_bg": 256,
        "variance": {"init_val": 0.3, "modulate": False},
        "geometry": {
            "name": "volume-sdf", "radius": 0.5, "feature_dim": 48,
            "grad_type": "analytic",
            "isosurface": {"method": "mc", "resolution": 512,
                           "chunk": 2097152, "threshold": 0.0},
            "xyz_encoding_config": {
                "otype": "HashGrid", "n_levels": 16,
                "n_features_per_level": 2, "log2_hashmap_size": 19,
                "base_resolution": 16, "per_level_scale": 1.447269237440378,
                "include_xyz": True},
            "mlp_network_config": dict(mlp, n_neurons=128, n_hidden_layers=2,
                                       sphere_init=True,
                                       sphere_init_radius=0.5,
                                       weight_norm=True)},
        "texture": {"name": "volume-radiance", "input_feature_dim": 51,
                    "dir_encoding_config": sh4,
                    "mlp_network_config": dict(mlp, n_neurons=128,
                                               n_hidden_layers=4),
                    "color_activation": "sigmoid"},
        "geometry_bg": {
            "name": "volume-density", "radius": 0.5, "feature_dim": 8,
            "density_activation": "trunc_exp", "density_bias": -1,
            "isosurface": None,
            "xyz_encoding_config": {
                "otype": "HashGrid", "n_levels": 16,
                "n_features_per_level": 2, "log2_hashmap_size": 19,
                "base_resolution": 32,
                "per_level_scale": 1.3195079107728942},
            "mlp_network_config": dict(mlp, n_neurons=64,
                                       n_hidden_layers=1)},
        "texture_bg": {"name": "volume-radiance", "input_feature_dim": 8,
                       "dir_encoding_config": sh4,
                       "mlp_network_config": dict(mlp, n_neurons=64,
                                                  n_hidden_layers=2),
                       "color_activation": "sigmoid"},
    }
    assert got["model"] == want_model
    assert got["dataset"] == {
        "name": "colmap", "root_dir": "???", "img_downscale": 4,
        "up_est_method": "ground", "center_est_method": "lookat",
        "n_test_traj_steps": 120, "apply_mask": False}
    system = got["system"]
    assert system["loss"] == {
        "lambda_rgb_mse": 10.0, "lambda_rgb_l1": 0.0, "lambda_mask": 0.0,
        "lambda_eikonal": 0.1, "lambda_sparsity": 0.01,
        "lambda_distortion": 0.0, "lambda_opaque": 0.0,
        "sparsity_scale": 1.0}
    assert system["optimizer"]["params"] == {
        "geometry": {"lr": 0.01}, "texture": {"lr": 0.01},
        "variance": {"lr": 0.001}, "geometry_bg": {"lr": 0.01},
        "texture_bg": {"lr": 0.01}}
    sched = system["scheduler"]
    assert sched["milestones"] == [500]
    assert sched["schedulers"][1]["args"]["gamma"] == \
        0.1 ** (1 / (20000 - 500))
    assert got["trainer"]["max_steps"] == 20000
    assert got["name"] == "neus-colmap-${basename:dataset.root_dir}"
    # the model builds: two hash grids of 16 x 2^19 x 2
    model = models.make("neus", got["model"])
    for m in (model.geometry, model.geometry_bg):
        assert tuple(m.encoding.encoding.table.shape) == (16, 2 ** 19, 2)


def test_contract_to_unisphere_matches_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(scale=s, size=(64, 3))
                        for s in (0.1, 1.0, 30.0, 1e3)]).astype(np.float32)
    x[0] = 0.0
    for radius in (0.5, 1.5):
        got = contract_to_unisphere(torch.from_numpy(x), radius).numpy()
        want = np.asarray(jcontract(jnp.asarray(x), radius))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.fixture(scope="module")
def models_pair():
    """The JAX NeuS model with a learned background, fresh params, and
    the port's with the same params through ``bridge``."""
    jcfg = jax_config()
    jm = jmodels.make("neus", jcfg.model)
    params = jm.init(jax.random.PRNGKey(3))
    tm = models.make("neus", port_config()["model"])
    tm.load_state_dict(bridge.from_jax_params(bridge.flatten_params(params)),
                       strict=True)
    return jm, params, tm


def test_bridge_round_trip_with_background_is_bit_equal(models_pair):
    jm, params, tm = models_pair
    want = bridge.flatten_params(params)
    got = bridge.to_jax_params(tm.state_dict())
    assert sorted(got) == sorted(want)
    assert {k for k in want if "_bg/" in k} == {
        "params/geometry_bg/encoding/table",
        *(f"params/geometry_bg/mlp/layers/{i}/{p}" for i in (0, 1)
          for p in "wb"),
        *(f"params/texture_bg/mlp/layers/{i}/{p}" for i in (0, 1, 2)
          for p in "wb")}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_volume_density_matches_jax(models_pair):
    jm, params, tm = models_pair
    rng = np.random.default_rng(2)
    u = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    jd, jf = jm.geometry_bg.forward(params["geometry_bg"], jnp.asarray(u), 5)
    with torch.no_grad():
        td, tf = tm.geometry_bg(torch.from_numpy(u), 5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **BG)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **BG)
    assert tf.shape == (200, 8)


def test_forward_bg_matches_jax(models_pair):
    jm, params, tm = models_pair
    rays = _rays(seed=4)
    want = jax.jit(lambda p, o, d: jm.forward_bg(p, o, d, 7))(
        params, jnp.asarray(rays[:, :3]), jnp.asarray(rays[:, 3:]))
    with torch.no_grad():
        got = tm.forward_bg(torch.from_numpy(rays[:, :3]),
                            torch.from_numpy(rays[:, 3:]), 7)
    for k in ("comp_rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **BG)
    assert bool(got["rays_valid"].all())


@pytest.mark.parametrize("train", [False, True])
def test_forward_with_learned_background_matches_jax(models_pair, train):
    jm, params, tm = models_pair
    rays = _rays(seed=5)
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    cap = 48 * 64
    want = jax.jit(lambda p, r, b: jm.forward(
        p, r, occ_binary=None, step=9, rng=None, train=train,
        capacity=cap, background_color=b))(params, jnp.asarray(rays),
                                           jnp.asarray(bg))
    with torch.set_grad_enabled(train):
        got = tm(torch.from_numpy(rays), occ_binary=None, step=9,
                 generator=None, train=train, capacity=cap,
                 background_color=torch.from_numpy(bg))
    assert bool(np.asarray(want["ray_included"]).all())
    keys = ["comp_rgb_full", "comp_rgb_bg", "opacity", "depth"]
    if train:
        keys += ["weights", "sdf_samples"]
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), err_msg=k, **FWD)
    assert int(got["num_samples"]) == int(want["num_samples"]) > 0


def _shell_grid(res=32, radius=1.5):
    c = (np.arange(res) + 0.5) / res * 2 * radius - radius
    p = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    return np.abs(np.linalg.norm(p, axis=-1) - 0.5) < 0.35


@pytest.mark.parametrize("grid_kind", ["full", "shell"])
def test_train_step_loss_and_grads_match_jax(pair, grid_kind):
    """One step's loss (with the distortion term at 0.01) and the
    gradient of every parameter, the background's included."""
    jsys, jstate, tsys, _, path, _ = pair
    tsys.load_checkpoint(path)
    data = tsys.device_data(tsys.datamodule.train())
    b = {k: v.numpy() for k, v in tsys.sample_batch(
        torch.Generator().manual_seed(4), data).items()}
    grid = (np.ones(32 ** 3, bool) if grid_kind == "full"
            else _shell_grid())
    batch = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        return jsys.forward_loss(p, batch, jnp.asarray(grid), 5, None, None,
                                 jsys.capacity)

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jstate["params"])
    tsys.model.zero_grad(set_to_none=True)
    loss_t, aux_t = tsys.forward_loss(
        {k: torch.from_numpy(v) for k, v in b.items()},
        torch.from_numpy(grid), 5)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-4)
    for k in ("rgb_mse", "eikonal", "sparsity", "distortion", "num_rays",
              "num_samples"):
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(aux_t["distortion"].detach()) > 0
    want = bridge.flatten_params(grads_j)
    got = {bridge.jax_path(k): p.grad.numpy()
           for k, p in tsys.model.named_parameters()}
    assert sorted(got) == sorted(want)
    groups = {g["name"] for g in tsys.optimizer.param_groups}
    assert groups == {"geometry", "texture", "variance", "geometry_bg",
                      "texture_bg"}
    for k in want:
        if "_bg/" in k:
            assert np.abs(want[k]).max() > 0, k
        _assert_grad_close(got[k], want[k], k)


def test_distortion_loss_matches_jax_and_a_double_sum():
    rng = np.random.default_rng(6)
    counts = [5, 0, 9, 1, 7]
    n_rays, cap = len(counts), sum(counts) + 4
    w = rng.uniform(0, 0.3, cap).astype(np.float32)
    iv = rng.uniform(0.01, 0.05, cap).astype(np.float32)
    m = np.concatenate([np.sort(rng.uniform(0, 3, c)) for c in counts]
                       + [np.zeros(4)]).astype(np.float32)
    ridx = np.concatenate([np.full(c, r) for r, c in enumerate(counts)]
                          + [np.full(4, n_rays)]).astype(np.int64)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    valid = np.arange(cap) < sum(counts)
    ref = 0.0
    for s, c in zip(start, counts):
        wr, mr, ivr = (x[s:s + c].astype(np.float64) for x in (w, m, iv))
        ref += np.sum(wr[:, None] * wr[None, :]
                      * np.abs(mr[:, None] - mr[None, :]))
        ref += np.sum(wr ** 2 * ivr) / 3.0
    args = (w, m, iv, ridx, start, valid)
    got = volrend.distortion_loss(*map(torch.from_numpy, args), n_rays)
    want = jdistortion(*map(jnp.asarray, args), n_rays)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)
    # dead slots do not count
    w2 = w.copy()
    w2[~valid] = 5.0
    args2 = (w2, m, iv, ridx, start, valid)
    assert float(volrend.distortion_loss(*map(torch.from_numpy, args2),
                                         n_rays)) == float(got)


@pytest.mark.parametrize("cone_angle", [0.004, 0.05])
def test_cone_angle_candidate_intervals_match_jax(cone_angle):
    rays = _rays(16, seed=8, dist=2.5)
    o, d = rays[:, :3], rays[:, 3:]
    lo, hi = np.full(3, -1.5, np.float32), np.full(3, 1.5, np.float32)
    tn, tf = jmarch.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(lo), jnp.asarray(hi))
    step, s, dt_max = 0.01, 96, 0.06
    want = jmarch.candidate_intervals(jnp.asarray(o), jnp.asarray(d), tn,
                                      tf, step, s, cone_angle=cone_angle,
                                      dt_max=dt_max)
    got = march.candidate_intervals(torch.from_numpy(np.array(tn)),
                                    torch.from_numpy(np.array(tf)), step,
                                    s, cone_angle=cone_angle, dt_max=dt_max)
    for a, b, name in zip(got, want, ("t_starts", "t_ends", "in_range")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    widths = (got[1] - got[0]).numpy()
    assert widths.min() == pytest.approx(step, rel=1e-5)
    assert (np.diff(widths, axis=1) >= -1e-6).all()


def test_cone_angle_forward_matches_jax():
    """The NeuS eval forward with ``cone_angle`` 0.01 (and the learned
    background)."""
    jm = jmodels.make("neus", jax_config(cone_angle=0.01).model)
    params = jm.init(jax.random.PRNGKey(5))
    tm = models.make("neus", port_config(cone_angle=0.01)["model"])
    tm.load_state_dict(bridge.from_jax_params(bridge.flatten_params(params)))
    rays = _rays(seed=9)
    want = jax.jit(lambda p, r: jm.forward(
        p, r, occ_binary=None, step=3, rng=None, train=False,
        capacity=48 * 64, background_color=jnp.ones(3)))(
            params, jnp.asarray(rays))
    with torch.no_grad():
        got = tm(torch.from_numpy(rays), occ_binary=None, step=3,
                 capacity=48 * 64, background_color=torch.ones(3))
    for k in ("comp_rgb_full", "opacity", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **FWD)
    assert int(got["num_samples"]) == int(want["num_samples"]) > 0


def test_sdf_activation_matches_jax():
    geo = dict(jpresets.geometry_cfg("analytic"), sdf_activation="tanh",
               sdf_bias=0.1)
    jg = jmodels.make("volume-sdf", geo)
    params = jg.init(jax.random.PRNGKey(7))
    tg = models.make("volume-sdf", geo)
    flat = bridge.flatten_params({"geometry": params})
    tg.load_state_dict({k[len("geometry."):]: v for k, v in
                        bridge.from_jax_params(flat).items()})
    x = np.random.default_rng(10).uniform(-1.4, 1.4, (64, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, xx: jg.forward(p, xx, 0, with_grad=True,
                                            with_feature=True))(
        params, jnp.asarray(x))
    got = tg(torch.from_numpy(x), 0, with_grad=True, with_feature=True)
    for k in ("sdf", "grad", "feature"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(np.abs(got["sdf"].detach().numpy()).max()) < 1.0  # tanh


def test_inside_outside_sphere_init_matches_jax():
    """The sphere init's last layer with ``inside_outside``: weights
    around -sqrt(pi / d_in) (1e-4 noise), bias +r, as JAX draws them;
    the field is then negative outside the sphere."""
    cfg = dict(jpresets.tiny_mlp(1, 16, sphere=True), inside_outside=True)
    jmlp = JMLP(3, 5, cfg)
    tmlp = MLP(3, 5, cfg)
    tmlp.reset_parameters(torch.Generator().manual_seed(0))
    jl = jmlp.init(jax.random.PRNGKey(0))["layers"][-1]
    tl = tmlp.layers[-1]
    np.testing.assert_array_equal(tl.b.detach().numpy(), np.asarray(jl["b"]))
    np.testing.assert_allclose(tl.v.detach().numpy(), np.asarray(jl["v"]),
                               atol=1e-3)
    assert float(tl.b[0]) == 0.5 and float(tl.v.mean()) < 0
    # with JAX's params the two MLPs agree
    tmlp.load_state_dict({f"layers.{i}.{k}": torch.from_numpy(np.array(v))
                          for i, layer in enumerate(
                              jmlp.init(jax.random.PRNGKey(0))["layers"])
                          for k, v in layer.items()})
    x = np.random.default_rng(12).uniform(-1, 1, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tmlp(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jmlp.apply(jmlp.init(jax.random.PRNGKey(0)),
                              jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    far = torch.tensor([[0.99, 0.0, 0.0]])
    assert float(tmlp(far)[0, 0]) < 0 < float(tmlp(torch.zeros(1, 3))[0, 0])


def test_background_in_the_gradient_bucket_and_checkpoint(pair, monkeypatch):
    """Over ranks ``train_step`` all-reduces one bucket: it holds every
    parameter's gradient, the background's included; the checkpoint
    holds the background under JAX's keys and its Adam moments, with the
    keys of the JAX system's checkpoint."""
    jsys, jstate, tsys, _, path, tmp = pair
    tstate = tsys.load_checkpoint(path)
    seen = []
    monkeypatch.setattr(sharding, "all_reduce_mean_",
                        lambda ts: seen.extend(ts))
    data = tsys.device_data(tsys.datamodule.train())
    batch = tsys.sample_batch(torch.Generator().manual_seed(2), data)
    tsys.train_step(tstate, batch, generator=None)
    ids = {id(t) for t in seen}
    names = [n for n, p in tsys.model.named_parameters()
             if id(p.grad) in ids]
    assert names == [n for n, _ in tsys.model.named_parameters()]
    assert any(n.startswith("geometry_bg.") for n in names)
    assert any(n.startswith("texture_bg.") for n in names)
    out = tsys.save_checkpoint(tstate, os.path.join(tmp, "bg.ckpt.npz"))
    got, want = bridge.load_npz(out), bridge.load_npz(path)
    assert sorted(got) == sorted(want)
    for key in ("params/geometry_bg/encoding/table",
                "opt_state/0/mu/geometry_bg/encoding/table",
                "opt_state/0/nu/texture_bg/mlp/layers/2/w"):
        assert key in got and got[key].shape == want[key].shape
    assert int(got["opt_state/0/count"]) == 1
