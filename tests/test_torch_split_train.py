"""Port parity for the flagship's training step at ``tiny_split_config``.

One train step's loss, every loss term and every parameter gradient at
stage 0 (step 5: two hash levels open, all in the fine band) and stage 1
(step 30: four open, the coarse band one level), with the visibility
prefilter off and on, against the JAX ``SplitOccSystem.forward_loss``
(jitted) on the same parameters, rays and curvature-probe directions;
three Adam steps across the stage flip; the port's own 15-step ``fit``
across the flip, ``validate`` and a checkpoint reload; and
``split_mixed_occ_train_full`` against the flagship's yaml.

Both sides march unstratified (``randomized: False``): jax.random and
torch draw different numbers, so the curvature probe's directions are
JAX's draws ``uniform(split(rng, 3)[2], (capacity, 3))``, handed to the
port.  The parameters are the JAX init perturbed by seeded noise, so
that the hash table and the heads' feature inputs get nonzero gradients
(the sphere-init first layer reads xyz only).

Tolerances are those of ``tests/test_torch_neus.py``: the loss and its
terms to rtol 1e-4, each gradient to 1e-3 of its tensor's largest entry.
Both sides take the transmittance as one float32 cumsum over the whole
sample buffer (the JAX design), so each side's weights carry ~1e-5 of
rounding error, summed in another order by each framework."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import presets as jpresets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu_torch import bridge, datasets, presets, systems
from rise_sdf_tpu_torch.systems.optim import make_optimizer

RNG = jax.random.PRNGKey(11)


def _assert_grad_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * float(np.abs(want).max()),
                               err_msg=name)


def _configs(prefilter):
    """The JAX and port tiny split configs, unstratified, with the
    visibility prefilter from its kick-in step when ``prefilter``."""
    jcfg, cfg = jpresets.tiny_split_config(), presets.tiny_split_config()
    extra = {"randomized": False, "visibility_prefilter": prefilter}
    jcfg.model.merge(extra)
    cfg["model"].update(extra)
    return jcfg, cfg


def _shell_grid(res=32, radius=1.5):
    """Occupancy of a shell around the sphere (a pruned grid)."""
    c = (np.arange(res) + 0.5) / res * 2 * radius - radius
    p = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    return np.abs(np.linalg.norm(p, axis=-1) - 0.5) < 0.35


def _perturbed(params, seed=3):
    """The JAX params plus seeded noise (0.05, the table 0.01)."""
    rng = np.random.default_rng(seed)
    flat = bridge.flatten_params(params)

    def noisy(path, leaf):
        key = "params/" + "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                                 k)))
                                   for k in path)
        scale = 0.01 if key.endswith("encoding/table") else 0.05
        noise = rng.standard_normal(flat[key].shape).astype(np.float32)
        return leaf + scale * jnp.asarray(noise)

    return jax.tree_util.tree_map_with_path(noisy, params)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Per prefilter flag: the JAX system and params, and the port system
    with the same params loaded through a JAX checkpoint file."""
    tmp = str(tmp_path_factory.mktemp("split_train"))
    out = {}
    for pf in (False, True):
        jcfg, cfg = _configs(pf)
        jsys = jsystems.make(jcfg.system.name, jcfg,
                             jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                             save_dir=os.path.join(tmp, f"jax{pf}"))
        jstate = jsys.init_state(0)
        jstate["params"] = _perturbed(jstate["params"])
        path = jsys.save_checkpoint(jstate, os.path.join(
            tmp, f"jax{pf}.ckpt.npz"))
        tsys = systems.make(cfg["system"]["name"], cfg,
                            datasets.make(cfg["dataset"]["name"],
                                          cfg["dataset"]),
                            save_dir=os.path.join(tmp, f"torch{pf}"),
                            device="cpu")
        tsys.init_state(1)  # other params, overwritten by the load
        out[pf] = (jsys, jstate, tsys, path)
    return out


def _batch(tsys, seed):
    data = tsys.device_data(tsys.datamodule.train())
    b = tsys.sample_batch(torch.Generator().manual_seed(seed), data)
    return {k: v.numpy() for k, v in b.items()}


def _jax_step_fn(jsys, b, grid, step, capacity):
    """Jitted value_and_grad of the JAX forward_loss at ``step``, with the
    fit's per-step flags, and the curvature directions it draws."""
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    model = jsys.model
    stage, levels = model.stage(step), model.open_levels(step)
    pf = jsys.train_prefilter(step)

    def loss_fn(p):
        return jsys.forward_loss(p, batch, jnp.asarray(grid), step, RNG,
                                 stage, capacity, levels=levels, prefilter=pf)

    n_dirs = -(-capacity // model.geometry.laplace_stride)
    dirs = jax.random.uniform(jax.random.split(RNG, 3)[2], (n_dirs, 3))
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True)), \
        torch.from_numpy(np.array(dirs))


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("step", [5, 30], ids=["stage0", "stage1"])
@pytest.mark.parametrize("prefilter", [False, True],
                         ids=["no_prefilter", "prefilter"])
def test_train_step_loss_and_grads_match_jax(pairs, step, prefilter):
    jsys, jstate, tsys, path = pairs[prefilter]
    tsys.load_checkpoint(path)
    b = _batch(tsys, 4)
    grid = _shell_grid()
    opts = tsys.train_options(step)
    assert opts["prefilter"] == (prefilter and step >= 10)
    assert opts["levels"] == jsys.model.open_levels(step)
    fn, dirs = _jax_step_fn(jsys, b, grid, step, opts["capacity"])
    (loss_j, aux_j), grads_j = fn(jstate["params"])
    tsys.model.zero_grad(set_to_none=True)
    loss_t, aux_t = tsys.forward_loss(_torch_batch(b),
                                      torch.from_numpy(grid), step,
                                      laplace_dirs=dirs, **opts)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-4)
    terms = {k for k in aux_j if k not in ("inv_s",)}
    assert terms == set(aux_t) - {"inv_s"}
    want_terms = {"rgb_mse", "eikonal", "mask", "sparsity", "curvature",
                  "normal_orientation", "num_rays", "num_samples"}
    if step >= 10:
        want_terms |= {"rgb_phys_mse"}
    assert want_terms <= terms
    for k in sorted(terms):
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert float(aux_t["curvature"].detach()) > 0
    want = bridge.flatten_params(grads_j)
    got = {bridge.jax_path(k): p.grad
           for k, p in tsys.model.named_parameters()}
    assert sorted(got) == sorted(want)
    # stage 0 builds no mips and reads no roughness: those parameters
    # are off the graph (JAX gives them zero gradients)
    off_graph = {k for k in want if k.startswith(("params/emitter",
                                                  "params/texture/roughness"))}
    assert {k for k, g in got.items() if g is None} == \
        (off_graph if step < 10 else set())
    for k in want:
        if got[k] is None:
            assert not np.any(want[k]), k
            continue
        got[k] = got[k].numpy()
        assert np.any(want[k]), k
        if k == "params/variance/variance" and step < 10:
            # At stage 0 the variance's gradient is a small difference of
            # the RGB and mask terms (-0.440 and +0.357 for a total of
            # -0.0863 in float64), which amplifies the float32 scan's
            # rounding on both sides: measured |port - f64| / |f64| =
            # 9.36e-3, |JAX - f64| / |f64| = 5.50e-3, |port - JAX| / |JAX|
            # = 3.84e-3.  Port, JAX and the port's float64 gradient are
            # held to each other at 1e-2; a lost normal-orientation term
            # (3.4 % of the total) would fail it.
            ref = _variance_grad_f64(tsys, path, b, grid, step, dirs, opts)
            for side in (got[k], want[k]):
                np.testing.assert_allclose(side, ref, rtol=1e-2, err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-2,
                                       err_msg=k)
            continue
        _assert_grad_close(got[k], want[k], k)


def _variance_grad_f64(tsys, path, b, grid, step, dirs, opts):
    """The variance's gradient of the port's train step in float64."""
    tsys.load_checkpoint(path)
    tsys.model.double()
    try:
        batch = {k: torch.from_numpy(v).double() if v.dtype == np.float32
                 else torch.from_numpy(v) for k, v in b.items()}
        loss, _ = tsys.forward_loss(batch, torch.from_numpy(grid), step,
                                    laplace_dirs=dirs.double(), **opts)
        g, = torch.autograd.grad(loss, tsys.model.variance.variance)
        return float(g)
    finally:
        tsys.model.float()


def test_three_adam_steps_across_the_stage_flip_match_jax(pairs):
    """Steps 8, 9, 10 (the stage flips at 10, and the prefilter with it)
    through the port's ``train_step`` and the JAX optimizer."""
    jsys, jstate, tsys, path = pairs[True]
    tstate = tsys.load_checkpoint(path)
    tsys.optimizer, tsys.scheduler = make_optimizer(tsys.config["system"],
                                                    tsys.model)
    grid = _shell_grid()
    tstate["occ_binary"] = torch.from_numpy(grid)
    tstate["step"] = 8
    params, opt_state = jstate["params"], jsys.tx.init(jstate["params"])
    grads_j = []
    for step in (8, 9, 10):
        b = _batch(tsys, 20 + step)
        fn, dirs = _jax_step_fn(jsys, b, grid, step,
                                tsys.train_options(step)["capacity"])
        (loss_j, _), grads = fn(params)
        updates, opt_state = jsys.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        grads_j.append(bridge.flatten_params(grads))
        aux = tsys.train_step(tstate, _torch_batch(b), generator=None,
                              laplace_dirs=dirs)
        np.testing.assert_allclose(float(aux["loss"]), float(loss_j),
                                   rtol=1e-4)
    assert tstate["step"] == 11 and tsys.skipped_updates == 0
    want = bridge.flatten_params(params)
    got = bridge.to_jax_params(tsys.model.state_dict())
    # The gradients agree to 1e-3 of each tensor's largest entry, so an
    # entry below 1e-2 of it carries relative noise of 10 % or more, and
    # Adam divides each gradient by its own magnitude: compare the
    # entries whose gradients are above 1e-2 of their tensor's largest at
    # every step that gives the tensor a gradient.  Stage 0 gives the
    # emitter and the roughness head exactly zero ones on both sides, so
    # they are compared on step 10's; their first update there is Adam's
    # third (about 0.64 lr), as optax counts every leaf from the first
    # step.  There the float32 scan error moves params by up to ~1 % of
    # one lr step: atol 1e-4 at lr 0.01.
    compared = {}
    for k in want:
        sel = np.ones(want[k].shape, bool)
        for g in grads_j:
            a = np.abs(g[k])
            if a.max() > 0:
                sel &= a > 1e-2 * a.max()
        compared[k] = int(sel.sum())
        np.testing.assert_allclose(got[k][sel], want[k][sel], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert sum(compared.values()) > 500
    flip = [k for k in want if k.startswith(("params/emitter",
                                             "params/texture/roughness"))]
    assert flip and all(not np.any(grads_j[0][k]) and compared[k] > 0
                        for k in flip), compared


def test_fit_across_the_flip_validate_and_reload(tmp_path):
    """The port's own 15-step fit (stage 1 from step 10), validation
    with PSNR and phys PSNR, and the checkpoint read back into a fresh
    system."""
    cfg = presets.tiny_split_config()
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    tsys = systems.make(cfg["system"]["name"], cfg, dm,
                        save_dir=str(tmp_path), device="cpu")
    seen = []
    state = tsys.fit(max_steps=15, log_every=1,
                     on_log=lambda step, m: seen.append(m))
    assert state["step"] == 15 and tsys.skipped_updates == 0
    assert all(np.isfinite(m["loss"]) for m in seen)
    assert "rgb_phys_mse" not in seen[9] and "rgb_phys_mse" in seen[10]
    assert all(torch.isfinite(p).all() for p in tsys.model.parameters())
    assert float(tsys.model.emitter.base.detach().std()) > 0
    res = tsys.validate(state, n_images=1)
    assert np.isfinite(res["psnr"]) and np.isfinite(res["phys_psnr"])
    assert res["dropped_rays"] == 0
    path = tsys.save_checkpoint(state)
    other = systems.make(cfg["system"]["name"], cfg, dm,
                         save_dir=str(tmp_path), device="cpu")
    other.init_state(0)
    state2 = other.load_checkpoint(path)
    assert state2["step"] == 15
    for (k, a), b in zip(tsys.model.state_dict().items(),
                         other.model.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    np.testing.assert_array_equal(state2["occ_binary"].numpy(),
                                  state["occ_binary"].numpy())


def _plain(node):
    if hasattr(node, "items"):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def test_train_full_preset_matches_yaml():
    """``split_mixed_occ_train_full`` is ``configs/split-mixed-occ-
    tensoir.yaml`` section by section (interpolations resolved by the
    JAX package's loader); the dataset is the one difference."""
    from rise_sdf_tpu.config import load_config

    got = presets.split_mixed_occ_train_full()
    scene = got["dataset"]["name"]
    want = _plain(load_config("configs/split-mixed-occ-tensoir.yaml",
                              cli_args=[f"dataset.scene={scene}"]))
    assert set(got) == set(want)
    for section in sorted(set(want) - {"dataset"}):
        assert got[section] == want[section], section
    assert want["dataset"]["name"] == "tensoir"
    assert got["dataset"]["img_wh"] == want["dataset"]["img_wh"]
    assert got["model"] == presets.split_mixed_occ_full()["model"]
