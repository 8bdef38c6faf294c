"""Port parity for the optimizer surface and variance modulation:
``ConstantLR`` and ``ChainedScheduler`` against ``make_lr_schedule``,
AdamW against the optax chain, the ``Identity`` MLP, the modulated
variance against ``rise_sdf_tpu/models/variance.py`` on
``tests/test_variance.py``'s cases, tiny-config train steps across
``mod_start_steps`` against JAX's step (Adam and AdamW, with JAX's decay
of ``prev_inv_s`` under AdamW), and the checkpoint round trip of the
modulated state under JAX's keys."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import nn as jnn
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.config import ConfigNode
from rise_sdf_tpu.models.variance import Variance as JVariance
from rise_sdf_tpu.systems.optim import make_lr_schedule
from rise_sdf_tpu.systems.optim import make_optimizer as jmake_optimizer
from rise_sdf_tpu_torch import bridge, datasets, nn as tnn, presets, systems
from rise_sdf_tpu_torch.models.variance import Variance
from rise_sdf_tpu_torch.systems.optim import make_lr_lambda, make_optimizer

from test_torch_neus import _shell_grid, _torch_batch

CONSTANT = {"name": "ConstantLR", "args": {"factor": 0.5, "total_iters": 4}}
EXPONENTIAL = {"name": "ExponentialLR", "args": {"gamma": 0.999}}
LINEAR = {"name": "LinearLR", "args": {"start_factor": 0.1,
                                       "end_factor": 1.0, "total_iters": 50}}
SCHEDULES = {
    "constant": CONSTANT,
    "constant-defaults": {"name": "ConstantLR", "args": {}},
    "chained": {"name": "ChainedScheduler",
                "schedulers": [CONSTANT, EXPONENTIAL]},
    "chained-constants": {"name": "ChainedScheduler",
                          "schedulers": [CONSTANT, {
                              "name": "ConstantLR",
                              "args": {"factor": 0.25,
                                       "total_iters": 10}}]},
    "chained-linear": {"name": "ChainedScheduler",
                       "schedulers": [LINEAR, CONSTANT]},
    "sequential-of-chained": {
        "name": "SequentialLR", "milestones": [100],
        "schedulers": [{"name": "ChainedScheduler",
                        "schedulers": [CONSTANT, LINEAR]}, EXPONENTIAL]},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_factors_match_jax(name):
    cfg = {"scheduler": SCHEDULES[name]}
    fj, ft = make_lr_schedule(cfg), make_lr_lambda(cfg)
    for step in range(301):
        got, want = ft(step), float(fj(step))
        kinds = str(SCHEDULES[name])
        if "Exponential" in kinds:
            # JAX takes gamma ** step in float32 (test_torch_neus.py)
            np.testing.assert_allclose(got, want, rtol=1e-6 + 1.2e-7 * step)
        elif "Linear" in kinds:
            # JAX's ramp is float32 arithmetic, the port's float64
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            # constant factors: the port's, rounded to JAX's float32,
            # are equal
            assert np.float32(got) == np.float32(want), (step, got, want)


def test_unknown_scheduler_and_optimizer_raise():
    with pytest.raises(ValueError, match="Unknown scheduler"):
        make_lr_lambda({"scheduler": {"name": "OneCycleLR", "args": {}}})
    model = torch.nn.Module()
    model.geometry = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer({"optimizer": {"name": "SGD"}}, model)


class _Toy(torch.nn.Module):
    """Top-level children as the models have them, the variance with
    its ``prev_inv_s`` buffer."""

    def __init__(self, params):
        super().__init__()
        self.geometry = torch.nn.Module()
        self.geometry.w = torch.nn.Parameter(torch.from_numpy(
            params["geometry"]["w"].copy()))
        self.texture = torch.nn.Module()
        self.texture.b = torch.nn.Parameter(torch.from_numpy(
            params["texture"]["b"].copy()))
        self.variance = torch.nn.Module()
        self.variance.variance = torch.nn.Parameter(torch.tensor(
            params["variance"]["variance"]))
        self.variance.register_buffer("prev_inv_s", torch.tensor(
            params["variance"]["prev_inv_s"]))


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_three_steps_match_optax(name):
    rng = np.random.RandomState(0)
    params = {"geometry": {"w": rng.randn(5, 3).astype(np.float32)},
              "texture": {"b": rng.randn(4).astype(np.float32)},
              "variance": {"variance": np.float32(0.3),
                           "prev_inv_s": np.float32(np.exp(3.0))}}
    cfg = {"optimizer": {"name": name,
                         "args": {"lr": 0.01, "betas": [0.9, 0.99],
                                  "eps": 1e-15, "weight_decay": 0.1},
                         "params": {"geometry": {"lr": 0.02},
                                    "variance": {"lr": 0.005}}},
           "scheduler": SCHEDULES["chained"]}
    tx = jmake_optimizer(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    model = _Toy(params)
    opt, sched = make_optimizer(cfg, model)
    assert isinstance(opt, torch.optim.AdamW) == (name == "AdamW")
    for step in range(3):
        grads = {"geometry": {"w": rng.randn(5, 3).astype(np.float32)},
                 "texture": {"b": rng.randn(4).astype(np.float32)},
                 "variance": {"variance": np.float32(rng.randn()),
                              "prev_inv_s": np.float32(0.0)}}
        updates, st = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                st, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        opt.zero_grad(set_to_none=True)
        for t, g in ((model.geometry.w, grads["geometry"]["w"]),
                     (model.texture.b, grads["texture"]["b"]),
                     (model.variance.variance,
                      grads["variance"]["variance"]),
                     (model.variance.prev_inv_s,
                      grads["variance"]["prev_inv_s"])):
            t.grad = torch.as_tensor(np.asarray(g)).reshape(t.shape)
        opt.step()
        sched.step()
    want = bridge.flatten_params(jp)
    got = bridge.to_jax_params(model.state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    prev = float(got["params/variance/prev_inv_s"])
    if name == "Adam":  # a zero gradient moves nothing
        assert prev == np.float32(np.exp(3.0))
    else:  # decayed by (1 - lr_group * schedule * wd) per step
        factor = np.prod([1 - 0.005 * make_lr_lambda(cfg)(s) * 0.1
                          for s in range(3)])
        np.testing.assert_allclose(prev, np.exp(3.0) * factor, rtol=1e-6)


def test_identity_matches_jax():
    cfg = {"otype": "Identity"}
    tmlp, jmlp = tnn.get_mlp(7, 3, cfg), jnn.get_mlp(7, 3, cfg)
    assert jmlp.init(jax.random.PRNGKey(0)) == {}
    assert list(tmlp.parameters()) == [] and tmlp.state_dict() == {}
    x = np.random.RandomState(1).randn(11, 7).astype(np.float32)
    np.testing.assert_array_equal(tmlp(torch.from_numpy(x)).numpy(),
                                  np.asarray(jmlp.apply({}, jnp.asarray(x))))
    # an empty subtree: no entries in JAX's flat params, none in the
    # port's state, and a model holding it loads strictly
    assert list(bridge.flatten_params({"mlp": {}, "b": np.zeros(2)})) == \
        ["params/b"]
    model = torch.nn.Module()
    model.mlp, model.b = tmlp, torch.nn.Parameter(torch.zeros(2))
    flat = bridge.to_jax_params(model.state_dict())
    assert list(flat) == ["params/b"]
    model.load_state_dict(bridge.from_jax_params(
        bridge.flatten_params({"mlp": {}, "b": np.ones(2, np.float32)})),
        strict=True)
    assert float(model.b.detach().sum()) == 2.0
    with pytest.raises(ValueError, match="Unknown MLP otype"):
        tnn.get_mlp(7, 3, {"otype": "FullyFusedMLP"})


def _ref_inv_s(variance_by_step, cfg, step):
    """``tests/test_variance.py``'s oracle of the reference's
    update_step / prev_inv_s logic."""
    prev = None
    for s in range(step + 1):
        if not s > cfg["mod_start_steps"]:
            prev = float(np.exp(variance_by_step[s] * 10.0))
    val = float(np.exp(variance_by_step[step] * 10.0))
    if step > cfg["mod_start_steps"]:
        cap = min((step / cfg["reach_max_steps"])
                  * (cfg["max_inv_s"] - prev) + prev, cfg["max_inv_s"])
        val = min(val, cap)
    return val


MOD = {"init_val": 0.3, "modulate": True, "mod_start_steps": 5,
       "reach_max_steps": 20, "max_inv_s": 1024.0}


def test_modulation_ramps_from_prev_inv_s_as_jax():
    var, jvar = Variance(MOD), JVariance(MOD)
    params = jvar.init(jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(var.prev_inv_s),
                               float(params["prev_inv_s"]), rtol=1e-7)
    variance_by_step = [0.3 + 0.05 * s for s in range(30)]
    for s in range(30):
        params["variance"] = jnp.asarray(variance_by_step[s], jnp.float32)
        with torch.no_grad():
            var.variance.fill_(variance_by_step[s])
        got = float(var.inv_s(s).detach())
        want = float(jvar.inv_s(params, s))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"step {s}")
        np.testing.assert_allclose(got, _ref_inv_s(variance_by_step, MOD, s),
                                   rtol=1e-4, err_msg=f"step {s}")
        params = jvar.post_update(params, s)
        var.post_update(s)
        np.testing.assert_allclose(float(var.prev_inv_s),
                                   float(params["prev_inv_s"]), rtol=1e-6)
    # no step: no cap, only the clamp to [1e-6, 1e6]
    with torch.no_grad():
        var.variance.fill_(1.2)
    assert float(var.inv_s().detach()) == pytest.approx(np.exp(12.0), rel=1e-5)
    with torch.no_grad():
        var.variance.fill_(1.75)
    assert float(var.inv_s().detach()) == 1e6


def test_no_collapse_at_mod_start():
    cfg = dict(MOD, mod_start_steps=100, reach_max_steps=100000)
    var = Variance(cfg)
    with torch.no_grad():
        var.variance.fill_(0.57)  # inv_s ~ 300
    var.post_update(100)  # capture prev at mod start
    got = float(var.inv_s(101).detach())
    assert got > 290.0, f"inv_s collapsed to {got} at mod start"


def test_unmodulated_passthrough():
    var = Variance({"init_val": 0.3, "modulate": False})
    assert "prev_inv_s" not in var.state_dict()
    np.testing.assert_allclose(float(var.inv_s(50).detach()), float(np.exp(3.0)),
                               rtol=1e-5)
    before = var.variance.detach().clone()
    var.post_update(50)
    assert torch.equal(var.variance.detach(), before)


def _modulated_config(optimizer):
    cfg = presets.tiny_neus_config()
    # prev_inv_s = e^3 ~ 20.1; the ramp climbs 0.4 per step after step 2
    cfg["model"]["variance"] = {"init_val": 0.3, "modulate": True,
                                "mod_start_steps": 2,
                                "reach_max_steps": 5000,
                                "max_inv_s": 2048.0}
    opt = cfg["system"]["optimizer"]
    opt["name"] = optimizer
    opt["args"]["weight_decay"] = 0.1
    opt["params"]["variance"]["lr"] = 0.01
    cfg["system"]["scheduler"] = copy.deepcopy(SCHEDULES["chained"])
    return cfg


def _systems(cfg, tmp):
    jcfg = ConfigNode(copy.deepcopy(cfg))
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                         save_dir=os.path.join(tmp, "jax"))
    jstate = jsys.init_state(0)
    path = jsys.save_checkpoint(jstate, os.path.join(tmp, "jax.ckpt.npz"))
    tsys = systems.make(cfg["system"]["name"], cfg,
                        datasets.make(cfg["dataset"]["name"], cfg["dataset"]),
                        save_dir=os.path.join(tmp, "torch"), device="cpu")
    tsys.init_state(1)
    tstate = tsys.load_checkpoint(path)
    return jsys, jstate, tsys, tstate, path


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_train_steps_across_mod_start_match_jax(tmp_path, optimizer):
    cfg = _modulated_config(optimizer)
    jsys, jstate, tsys, tstate, _ = _systems(cfg, str(tmp_path))
    grid = _shell_grid()
    tstate["occ_binary"] = torch.from_numpy(grid)
    params, opt_state = jstate["params"], jstate["opt_state"]

    @jax.jit
    def jstep(params, opt_state, batch, step):
        def loss_fn(p):
            return jsys.forward_loss(p, batch, jnp.asarray(grid), step, None,
                                     None, jsys.capacity)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = jsys.tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        return jsys.model.post_update(params, step), opt_state, loss, aux

    # inv_s and prev_inv_s are exp(10 * variance): the variance's ~1e-4
    # difference between the sides after a few Adam steps (the float32
    # scan, test_torch_neus.py) is 1e-3 of them; the decay of prev_inv_s
    # is held step by step on each side at 1e-6
    prevs, jprevs, capped = [], [], 0
    for step in range(6):
        data = tsys.device_data(tsys.datamodule.train())
        b = tsys.sample_batch(torch.Generator().manual_seed(20 + step), data)
        b = {k: v.numpy() for k, v in b.items()}
        params, opt_state, loss_j, aux_j = jstep(
            params, opt_state, {k: jnp.asarray(v) for k, v in b.items()},
            step)
        aux = tsys.train_step(tstate, _torch_batch(b), generator=None)
        np.testing.assert_allclose(float(aux["loss"]), float(loss_j),
                                   rtol=1e-4, err_msg=f"step {step}")
        np.testing.assert_allclose(float(aux["inv_s"].detach()), float(aux_j["inv_s"]),
                                   rtol=1e-3, err_msg=f"step {step}")
        raw = float(np.exp(10.0 * float(
            tsys.model.variance.variance.detach())))
        capped += float(aux["inv_s"].detach()) < 0.999 * raw
        prevs.append(float(tsys.model.variance.prev_inv_s))
        jprevs.append(float(params["variance"]["prev_inv_s"]))
        np.testing.assert_allclose(prevs[-1], jprevs[-1], rtol=1e-3,
                                   err_msg=f"prev_inv_s after step {step}")
    assert tstate["step"] == 6 and tsys.skipped_updates == 0
    assert capped > 0  # the ramp caps inv_s after step 2
    lam = make_lr_lambda(cfg["system"])
    for step in range(3, 6):
        if optimizer == "Adam":  # frozen at the step-2 value
            assert prevs[step] == prevs[2] and jprevs[step] == jprevs[2]
        else:  # decayed by (1 - lr_variance * schedule * wd)
            for p in (prevs, jprevs):
                np.testing.assert_allclose(
                    p[step] / p[step - 1], 1 - 0.01 * lam(step) * 0.1,
                    rtol=1e-6)
    want = bridge.flatten_params(params)
    got = bridge.to_jax_params(tsys.model.state_dict())
    assert sorted(got) == sorted(want)
    # 1% of one lr step, as test_torch_neus.py's three Adam steps
    np.testing.assert_allclose(got["params/variance/variance"],
                               np.asarray(want["params/variance/variance"]),
                               rtol=0, atol=1e-4)


def test_checkpoint_round_trip_with_jax_keys(tmp_path):
    cfg = _modulated_config("AdamW")
    jsys, jstate, tsys, tstate, path = _systems(cfg, str(tmp_path))
    np.testing.assert_array_equal(
        tsys.model.variance.prev_inv_s.numpy(),
        np.asarray(jstate["params"]["variance"]["prev_inv_s"]))
    tstate["occ_binary"] = torch.from_numpy(_shell_grid())
    data = tsys.device_data(tsys.datamodule.train())
    for step in range(4):
        b = tsys.sample_batch(torch.Generator().manual_seed(step), data)
        tsys.train_step(tstate, b, generator=None)
    out = tsys.save_checkpoint(tstate, str(tmp_path / "port.ckpt.npz"))
    saved, jax_keys = bridge.load_npz(out), bridge.load_npz(path)
    assert sorted(saved) == sorted(jax_keys)
    for k in ("params/variance/prev_inv_s", "opt_state/0/mu/variance/"
              "prev_inv_s", "opt_state/0/nu/variance/prev_inv_s",
              bridge.ADAMW_SCHEDULE_COUNT):
        assert k in saved, k
    assert int(saved[bridge.ADAMW_SCHEDULE_COUNT]) == 4
    other = systems.make(cfg["system"]["name"], cfg, tsys.datamodule,
                         save_dir=str(tmp_path / "o"), device="cpu")
    other.init_state(5)
    state2 = other.load_checkpoint(out)
    assert state2["step"] == 4
    for (k, a), b in zip(tsys.model.state_dict().items(),
                         other.model.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    for ga, gb in zip(tsys.optimizer.param_groups,
                      other.optimizer.param_groups):
        assert ga["lr"] == gb["lr"] and ga["weight_decay"] == \
            gb["weight_decay"]
        for pa, pb in zip(ga["params"], gb["params"]):
            sa, sb = tsys.optimizer.state[pa], other.optimizer.state[pb]
            for key in ("step", "exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(sa[key].numpy(),
                                              sb[key].numpy())
    # the resumed run takes the same next step as the uninterrupted one
    b = tsys.sample_batch(torch.Generator().manual_seed(9), data)
    state2["occ_binary"] = tstate["occ_binary"]
    tsys.train_step(tstate, b, generator=None)
    other.train_step(state2, b, generator=None)
    np.testing.assert_array_equal(tsys.model.variance.prev_inv_s.numpy(),
                                  other.model.variance.prev_inv_s.numpy())
