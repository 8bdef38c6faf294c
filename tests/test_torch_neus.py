"""Port parity for the NeuS training slice at ``tiny_neus_config``.

Checkpoint bridge round trip, the model forward, one train step's loss
and gradients, three Adam steps, the port's own 25-step ``fit`` with a
checkpoint reload, the synthetic-sphere images, and the port's freedom
from jax / yaml / rise_sdf_tpu imports.  The march runs unstratified
(``rng=None`` / ``generator=None``) wherever the two sides are compared,
since jax.random and torch draw different numbers."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import presets as jpresets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.systems.optim import make_lr_schedule
from rise_sdf_tpu_torch import bridge, datasets, presets, systems
from rise_sdf_tpu_torch.systems.optim import make_lr_lambda, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Both sides take the transmittance scan as one float32 cumsum over the
# whole sample buffer (ops/volrend.py), whose running log-transmittance
# reaches a few hundred here, so each side's weights carry ~1e-5 absolute
# rounding error, summed in another order by each framework.  Against
# the port run in float64, both float32 sides' gradients are off by up
# to 2.6e-4 of their tensor's largest entry.  Render outputs are held to
# 1e-4, the loss to rtol 1e-4, and each gradient to 1e-3 of its largest
# entry.
FWD = dict(rtol=1e-4, atol=1e-4)


def _assert_grad_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * float(np.abs(want).max()),
                               err_msg=name)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX system with fresh params, and the port system with the same
    params loaded through a JAX checkpoint file."""
    tmp = str(tmp_path_factory.mktemp("neus"))
    jcfg = jpresets.tiny_neus_config()
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                         save_dir=os.path.join(tmp, "jax"))
    jstate = jsys.init_state(0)
    path = jsys.save_checkpoint(jstate, os.path.join(tmp, "jax.ckpt.npz"))
    cfg = presets.tiny_neus_config()
    tsys = systems.make(cfg["system"]["name"], cfg,
                        datasets.make(cfg["dataset"]["name"], cfg["dataset"]),
                        save_dir=os.path.join(tmp, "torch"), device="cpu")
    tsys.init_state(1)  # other params, overwritten by the load
    tstate = tsys.load_checkpoint(path)
    return jsys, jstate, tsys, tstate, path, tmp


def _shell_grid(res=32, radius=1.5):
    """Occupancy of a shell around the sphere (a pruned grid)."""
    c = (np.arange(res) + 0.5) / res * 2 * radius - radius
    p = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    return np.abs(np.linalg.norm(p, axis=-1) - 0.5) < 0.35


def _batch(tsys, seed):
    data = tsys.device_data(tsys.datamodule.train())
    b = tsys.sample_batch(torch.Generator().manual_seed(seed), data)
    return {k: v.numpy() for k, v in b.items()}


def test_presets_match_jax():
    assert presets.tiny_neus_config() == jpresets.tiny_neus_config()
    full = presets.neus_sphere_full()
    assert full["model"]["texture"]["input_feature_dim"] == 51
    assert full["model"]["geometry"]["xyz_encoding_config"][
        "log2_hashmap_size"] == 19


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_lr_schedule_matches_jax(which):
    cfg = (presets.tiny_neus_config() if which == "tiny"
           else presets.neus_sphere_full())["system"]
    fj, ft = make_lr_schedule(cfg), make_lr_lambda(cfg)
    for step in (0, 1, 24, 250, 499, 500, 501, 10000, 29999):
        # JAX takes gamma ** step in float32 from a float32-rounded gamma
        # (relative error up to 2^-24 per power); the port in float64
        np.testing.assert_allclose(ft(step), float(fj(step)),
                                   rtol=1e-6 + 1.2e-7 * step)


def test_bridge_round_trip_is_bit_equal(pair):
    jsys, jstate, tsys, tstate, path, tmp = pair
    out = tsys.save_checkpoint(tstate, os.path.join(tmp, "port.ckpt.npz"))
    src, dst = bridge.load_npz(path), bridge.load_npz(out)
    params = sorted(k for k in src if k.startswith("params/"))
    assert params == sorted(k for k in dst if k.startswith("params/"))
    # table + 2 sdf layers x (v, g, b) + 3 radiance layers x (w, b) + variance
    assert len(params) == 14
    for k in params + ["occs", "occ_binary", "step"]:
        assert src[k].dtype == dst[k].dtype, k
        np.testing.assert_array_equal(dst[k], src[k], err_msg=k)
    assert tstate["step"] == 0


def test_forward_matches_jax(pair):
    jsys, jstate, tsys, tstate, _, _ = pair
    b = _batch(tsys, 3)
    grid = _shell_grid()
    cap = tsys.eval_capacity
    want = jax.jit(lambda p, rays, occ, bg: jsys.model.forward(
        p, rays, occ_binary=occ, step=7, rng=None, train=False, capacity=cap,
        background_color=bg))(jstate["params"], jnp.asarray(b["rays"]),
                              jnp.asarray(grid), jnp.asarray(b["bg"]))
    with torch.no_grad():
        got = tsys.model(torch.from_numpy(b["rays"]),
                         occ_binary=torch.from_numpy(grid), step=7,
                         generator=None, train=False, capacity=cap,
                         background_color=torch.from_numpy(b["bg"]))
    assert bool(np.asarray(want["ray_included"]).all())
    for k in ("comp_rgb_full", "opacity", "depth", "comp_normal"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **FWD)
    assert int(got["num_samples"]) == int(want["num_samples"]) > 0


def _jax_loss_fn(jsys, b, grid, step):
    batch = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        return jsys.forward_loss(p, batch, jnp.asarray(grid), step, None,
                                 None, jsys.capacity)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("grid_kind", ["full", "shell"])
def test_train_step_loss_and_grads_match_jax(pair, grid_kind):
    jsys, jstate, tsys, _, path, _ = pair
    tsys.load_checkpoint(path)
    b = _batch(tsys, 4)
    grid = (np.ones(32 ** 3, bool) if grid_kind == "full"
            else _shell_grid())
    (loss_j, aux_j), grads_j = _jax_loss_fn(jsys, b, grid, 5)(
        jstate["params"])
    tsys.model.zero_grad(set_to_none=True)
    loss_t, aux_t = tsys.forward_loss(_torch_batch(b),
                                      torch.from_numpy(grid), 5)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-4)
    for k in ("rgb_mse", "eikonal", "mask", "sparsity", "num_rays",
              "num_samples"):
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]),
                                   rtol=1e-4, err_msg=k)
    if grid_kind == "full":  # the sample buffer overflows: rays dropped
        assert float(aux_t["num_rays"]) < 64
    want = bridge.flatten_params(grads_j)
    got = {bridge.jax_path(k): p.grad.numpy()
           for k, p in tsys.model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_grad_close(got[k], want[k], k)


def test_three_adam_steps_match_jax(pair):
    jsys, jstate, tsys, _, path, _ = pair
    tstate = tsys.load_checkpoint(path)
    tsys.optimizer, tsys.scheduler = make_optimizer(tsys.config["system"],
                                                    tsys.model)
    grid = _shell_grid()
    tstate["occ_binary"] = torch.from_numpy(grid)
    params, opt_state = jstate["params"], jsys.tx.init(jstate["params"])
    grad0 = None
    for step in range(3):
        b = _batch(tsys, 10 + step)
        (loss_j, _), grads = _jax_loss_fn(jsys, b, grid, step)(params)
        updates, opt_state = jsys.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if grad0 is None:
            grad0 = bridge.flatten_params(grads)
        aux = tsys.train_step(tstate, _torch_batch(b), generator=None)
        np.testing.assert_allclose(float(aux["loss"]), float(loss_j),
                                   rtol=1e-4)
    assert tstate["step"] == 3 and tsys.skipped_updates == 0
    want = bridge.flatten_params(params)
    got = bridge.to_jax_params(tsys.model.state_dict())
    # Adam with eps 1e-15 moves a near-zero gradient by about +-lr
    # whatever the sign of its rounding noise: compare where the first
    # gradient is well above that noise (the hash table's first gradient
    # is exactly zero: the sphere-init first layer reads xyz only).  Adam
    # divides each gradient by its own magnitude, so the gradients'
    # float32 scan error (see FWD) moves params by up to ~1% of one lr
    # step: atol 1e-4 at lr 0.01.
    compared = 0
    for k in want:
        sel = np.abs(grad0[k]) > 1e-6
        compared += int(sel.sum())
        np.testing.assert_allclose(got[k][sel], want[k][sel], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert compared > 500


def test_fit_and_checkpoint_reload(tmp_path):
    cfg = presets.tiny_neus_config()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    tsys = systems.make(cfg["system"]["name"], cfg, dm,
                        save_dir=str(tmp_path), device="cpu")
    state = tsys.fit(max_steps=25, log_every=0)
    assert state["step"] == 25 and tsys.skipped_updates == 0
    assert all(torch.isfinite(p).all() for p in tsys.model.parameters())
    frac = float(state["occ_binary"].float().mean())
    assert 0.0 < frac <= 1.0
    res = tsys.validate(state, n_images=1)
    assert np.isfinite(res["psnr"]) and res["psnr"] > 5.0
    path = tsys.save_checkpoint(state)
    other = systems.make(cfg["system"]["name"], cfg, dm,
                         save_dir=str(tmp_path), device="cpu")
    other.init_state(0)
    state2 = other.load_checkpoint(path)
    assert state2["step"] == 25
    for (k, a), b in zip(tsys.model.state_dict().items(),
                         other.model.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    np.testing.assert_array_equal(state2["occ_binary"].numpy(),
                                  state["occ_binary"].numpy())


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_sphere_images_equal_jax(split):
    cfg = presets.tiny_neus_config()["dataset"]
    got = datasets.make(cfg["name"], cfg).split(split)
    want = jdatasets.make(cfg["name"], dict(cfg)).split(split)
    for k in ("all_images", "all_fg_masks", "all_c2w", "directions"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


def test_port_imports_no_jax_yaml_or_reference():
    code = (
        "import pkgutil, sys, importlib, rise_sdf_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'yaml', 'rise_sdf_tpu'))\n"
        "assert not bad, bad\n"
        "need = [p.__name__ + '.' + m for m in ('bench',\n"
        "        'models.split_mixed_occ', 'ops.sdf_bake', 'ops.prefilter',\n"
        "        'ops.gather', 'ops.cubemap', 'models.light',\n"
        "        'systems.split_occ', 'measure', 'export', 'ops.mcubes',\n"
        "        'launch', 'bridge')]\n"
        "assert all(m in sys.modules for m in need), need\n"
        "from rise_sdf_tpu_torch.bridge import to_jax_state, from_jax_state\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 30
