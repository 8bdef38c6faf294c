"""The port's whole-state checkpoint (``systems/base.py``, ``bridge.py``)
and ``fit``'s resume, held against the JAX package.

* Resume: 12 steps of ``fit`` equal 6 steps, a save, a new system,
  ``load_checkpoint`` and 6 more, bit for bit (every param, Adam moment
  and count, the schedule's count, ``occs`` and ``occ_binary``), on
  ``tiny_neus_config`` and on ``tiny_split_config`` across its stage
  flip at step 10 (the port's ``tests/test_resume.py``).
* The cases of ``tests/test_checkpoint.py``: the round trip, a wrong
  shape and a missing key raising with the state path, weights-only
  with a fresh optimizer, an atomic async save, two overlapping async
  saves; also a failed async save raising when it is joined, and
  ``fit``'s saves of ``latest.ckpt.npz``, its validation and its
  windowed rate.
* Interop: a JAX checkpoint after 3 steps of JAX ``fit`` loads whole in
  the port (moments and counts equal JAX's leaves); one port
  ``train_step`` and one JAX step from it on the same batch agree to the
  tolerance of ``test_torch_neus.py::test_three_adam_steps_match_jax``
  (params within rtol 1e-4 and atol 1e-4 where the step's gradient is
  above 1e-6: Adam divides each gradient by its own magnitude, so the
  float32 scan's rounding moves a parameter by up to ~1 % of one lr
  step); the port's file loads in JAX's ``load_checkpoint`` and equals
  it leaf by leaf.
"""

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


def _system(cfg, save_dir):
    dm = datasets.make(cfg["dataset"]["name"], cfg["dataset"])
    return systems.make(cfg["system"]["name"], cfg, dm, save_dir=save_dir,
                        device="cpu")


def _whole_state(system, state):
    """Every tensor of the training state, by JAX path."""
    flat = bridge.to_jax_state(system.model, system.optimizer,
                               system.scheduler)
    flat["occs"] = state["occs"].numpy()
    flat["occ_binary"] = state["occ_binary"].numpy()
    flat["step"] = np.asarray(state["step"])
    return flat


@pytest.fixture(scope="module")
def neus(tmp_path_factory):
    """A tiny NeuS system after 3 steps of ``fit``."""
    tmp = str(tmp_path_factory.mktemp("ckpt"))
    system = _system(presets.tiny_neus_config(), tmp)
    state = system.fit(max_steps=3, seed=5, log_every=0)
    return system, state, tmp


@pytest.mark.parametrize("preset", ["tiny_neus_config", "tiny_split_config"])
def test_resume_matches_uninterrupted(preset, tmp_path):
    cfg = getattr(presets, preset)()
    seed = 7
    whole = _system(cfg, str(tmp_path / "a"))
    state_a = whole.fit(max_steps=12, seed=seed, log_every=0)
    first = _system(cfg, str(tmp_path / "b"))
    mid = first.fit(max_steps=6, seed=seed, log_every=0)
    path = first.save_checkpoint(mid)
    resumed = _system(cfg, str(tmp_path / "c"))
    resumed.init_state(0)  # other params, replaced by the load
    state = resumed.load_checkpoint(path)
    assert state["step"] == 6
    state_b = resumed.fit(max_steps=12, seed=seed, state=state, log_every=0)
    if preset == "tiny_split_config":
        assert whole.model.stage(5) == 0 and whole.model.stage(11) == 1
    a, b = _whole_state(whole, state_a), _whole_state(resumed, state_b)
    assert sorted(a) == sorted(b)
    assert int(a[bridge.ADAM_COUNT]) == int(a[bridge.SCHEDULE_COUNT]) == 12
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_round_trip_holds_the_whole_state(neus, tmp_path):
    system, state, _ = neus
    path = system.save_checkpoint(state, str(tmp_path / "a.ckpt.npz"))
    with np.load(path) as data:
        assert all(k.startswith("k:") for k in data.files)
    other = _system(presets.tiny_neus_config(), str(tmp_path))
    other.init_state(1)
    loaded = other.load_checkpoint(path)
    want, got = _whole_state(system, state), _whole_state(other, loaded)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the groups' lr follow the schedule's count
    for g_got, g_want in zip(other.optimizer.param_groups,
                             system.optimizer.param_groups):
        assert g_got["lr"] == g_want["lr"]


def _rewrite(path, out, **changes):
    flat = bridge.load_npz(path)
    for k, v in changes.items():
        if v is None:
            del flat[k]
        else:
            flat[k] = v
    return bridge.save_npz(out, flat)


@pytest.mark.parametrize("key", ["occs", "opt_state/0/mu/variance/variance"])
def test_wrong_shape_raises_naming_the_path(neus, tmp_path, key):
    system, state, _ = neus
    path = system.save_checkpoint(state, str(tmp_path / "b.ckpt.npz"))
    bad = _rewrite(path, str(tmp_path / "bad.ckpt.npz"),
                   **{key: np.zeros((17,), np.float32)})
    with pytest.raises(ValueError, match=key) as err:
        system.load_checkpoint(bad)
    assert "(17,)" in str(err.value)


@pytest.mark.parametrize("key", ["opt_state/0/nu/geometry/encoding/table",
                                 "opt_state/2/count", "occ_binary"])
def test_missing_key_raises(neus, tmp_path, key):
    system, state, _ = neus
    path = system.save_checkpoint(state, str(tmp_path / "c.ckpt.npz"))
    bad = _rewrite(path, str(tmp_path / "bad.ckpt.npz"), **{key: None})
    with pytest.raises(KeyError, match=key):
        system.load_checkpoint(bad)


def test_weights_only_keeps_a_fresh_optimizer(neus, tmp_path):
    system, state, _ = neus
    path = system.save_checkpoint(state, str(tmp_path / "d.ckpt.npz"))
    other = _system(presets.tiny_neus_config(), str(tmp_path))
    loaded = other.load_weights_only(path)
    assert loaded["step"] == 3
    for (k, a), b in zip(system.model.state_dict().items(),
                         other.model.state_dict().values()):
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=k)
    assert len(other.optimizer.state) == 0
    assert other.scheduler.last_epoch == 0
    # the file still holds JAX's whole state: only params, grid and step
    # are read, so a weights-only load tolerates missing moments
    bare = _rewrite(path, str(tmp_path / "bare.ckpt.npz"),
                    **{bridge.ADAM_COUNT: None})
    assert other.load_weights_only(bare)["step"] == 3


def test_async_save_is_atomic_and_loads(neus, tmp_path):
    system, state, _ = neus
    p_sync = system.save_checkpoint(state, str(tmp_path / "s.ckpt.npz"))
    p_async = system.save_checkpoint(state, str(tmp_path / "a.ckpt.npz"),
                                     async_write=True)
    system.wait_checkpoint_writer()
    assert not os.path.exists(p_async + ".tmp")
    a, b = bridge.load_npz(p_sync), bridge.load_npz(p_async)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_overlapping_async_saves_serialize(neus, tmp_path):
    system, state, _ = neus
    p = str(tmp_path / "latest.ckpt.npz")
    system.save_checkpoint(state, p, async_write=True)
    system.save_checkpoint(dict(state, step=state["step"] + 1), p,
                           async_write=True)
    system.wait_checkpoint_writer()
    assert int(bridge.load_npz(p)["step"]) == int(state["step"]) + 1


def test_failed_async_save_raises_on_join(neus, tmp_path):
    system, state, _ = neus
    blocker = tmp_path / "file"
    blocker.write_text("")
    system.save_checkpoint(state, str(blocker / "x.ckpt.npz"),
                           async_write=True)
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        system.wait_checkpoint_writer()
    system.wait_checkpoint_writer()  # nothing left in flight


def test_fit_saves_latest_and_validates(tmp_path, capsys):
    cfg = presets.tiny_neus_config()
    cfg["trainer"]["save_every_n_steps"] = 4
    system = _system(cfg, str(tmp_path))
    rates = []
    state = system.fit(max_steps=10, seed=3, log_every=1, val_every=8,
                       on_log=lambda step, m: rates.append(
                           m["steps_per_sec_window"]))
    assert "val/psnr" in capsys.readouterr().out
    ckpt = os.path.join(str(tmp_path), "ckpt")
    assert sorted(os.listdir(ckpt)) == ["latest.ckpt.npz",
                                        "step_10.ckpt.npz"]
    # the last save after step 8 holds the state after it
    assert int(bridge.load_npz(os.path.join(
        ckpt, "latest.ckpt.npz"))["step"]) == 9
    assert state["step"] == 10 and len(rates) == 10 and rates[0] == 0.0
    assert all(r > 0 for r in rates[1:])


# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX ``tiny_neus_config`` after 3 steps of ``fit``, its checkpoint,
    and the port system loaded from it."""
    tmp = str(tmp_path_factory.mktemp("interop"))
    jcfg = jpresets.tiny_neus_config()
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                         save_dir=os.path.join(tmp, "jax"))
    jstate = jsys.fit(max_steps=3, seed=2, log_every=0)
    path = os.path.join(jsys.ckpt_dir, "step_3.ckpt.npz")
    tsys = _system(presets.tiny_neus_config(), os.path.join(tmp, "torch"))
    tsys.init_state(1)
    tstate = tsys.load_checkpoint(path)
    return jsys, jstate, tsys, tstate, tmp


def _jax_leaves(jsys, state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jsys._path_str(p): np.asarray(leaf) for p, leaf in flat}


def test_jax_checkpoint_loads_whole(jax_run):
    jsys, jstate, tsys, tstate, _ = jax_run
    want = _jax_leaves(jsys, jstate)
    got = _whole_state(tsys, tstate)
    assert sorted(got) == sorted(want)
    assert int(want[bridge.ADAM_COUNT]) == int(want[bridge.SCHEDULE_COUNT]) \
        == tstate["step"] == 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    steps = {float(s["step"]) for s in tsys.optimizer.state.values()}
    assert steps == {3.0}


def test_one_step_from_a_jax_checkpoint_matches_jax(jax_run):
    jsys, jstate, tsys, tstate, _ = jax_run
    tstate = dict(tstate)
    data = tsys.device_data(tsys.datamodule.train())
    b = {k: v.numpy() for k, v in tsys.sample_batch(
        torch.Generator().manual_seed(11), data).items()}
    grid = np.asarray(jstate["occ_binary"])
    batch = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        return jsys.forward_loss(p, batch, jnp.asarray(grid), 3, None, None,
                                 jsys.capacity)

    (loss_j, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate["params"])
    updates, opt_state = jsys.tx.update(grads, jstate["opt_state"],
                                        jstate["params"])
    params = optax.apply_updates(jstate["params"], updates)
    aux = tsys.train_step(tstate, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, generator=None)
    np.testing.assert_allclose(float(aux["loss"]), float(loss_j), rtol=1e-4)
    assert tstate["step"] == 4 and tsys.scheduler.last_epoch == 4
    want = bridge.flatten_params(params)
    got = bridge.to_jax_params(tsys.model.state_dict())
    g = bridge.flatten_params(grads)
    compared = 0
    for k in want:
        sel = np.abs(g[k]) > 1e-6
        compared += int(sel.sum())
        np.testing.assert_allclose(got[k][sel], want[k][sel], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert compared > 500
    assert int(opt_state[0].count) == 4


def test_port_checkpoint_loads_in_jax(jax_run):
    jsys, jstate, tsys, tstate, tmp = jax_run
    path = tsys.save_checkpoint(tstate, os.path.join(tmp, "port.ckpt.npz"))
    loaded = jsys.load_checkpoint(path, jsys.init_state(0))
    got = _jax_leaves(jsys, loaded)
    flat = bridge.load_npz(path)
    want = _whole_state(tsys, tstate)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == flat[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
