"""Port parity: the sphere-traced eval (``ops/sphere_trace.py``,
``forward_surface``, ``forward_surface_multi``, the surface chunk and
its volumetric residual re-render) against the JAX package on the CPU.

* The trace alone, on the rays and SDFs of ``tests/test_sphere_trace.py``
  (the analytic sphere, a 0.6x-scaled distance bound, and a 0.05x bound
  starved at 8 iterations).  In float64 (JAX under ``jax.enable_x64``)
  every ``TraceResult`` field agrees to 1e-6 and the booleans are equal.
  In float32 the hits agree to 1e-6 too, but a miss's exit ``t`` and
  last SDF differ by up to 4.9e-5: XLA fuses ``t + relax * s`` into one
  fused multiply-add on the CPU, where the port rounds twice, and a ray
  marching away from the surface amplifies that ulp at each step; so
  float32 misses are held to 1e-4.
* ``forward_surface`` at ``tiny_split_config`` (stage 1, step 20,
  variance 0.9: inv_s ~ 8103) on 128 fan rays, over full, shell and
  absent occupancy, the clearance gate at 0 and 4 and relighting off and
  on; ``forward_surface_multi`` under the learned light and one relight
  light.  Every eval channel within 1e-4 (``tests/test_torch_split.py``'s
  bound), ``ray_included``, the hit mask and the counts equal.
* The split system with ``eval_mode: sphere_trace`` against the JAX
  system's ``render_image`` on view 0, in float64: a starved trace (1
  iteration, no refinement) sends every ray to the residual, the
  default trace with the guard sends part of them, and a starved trace
  with the residual's buffer cut to 8 slots per ray drops the rays JAX
  drops (the residual does not escalate); resolved rows of the merged chunk
  are bit-identical to the raw surface chunk; an explicit capacity or an
  escalation stays volumetric.

Each JAX reference runs once per module under ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import models as jmodels
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.ops.sphere_trace import sphere_trace as jtrace
from rise_sdf_tpu.presets import tiny_split_config as jtiny
from rise_sdf_tpu_torch import bridge, datasets, models, presets, systems
from rise_sdf_tpu_torch.ops import scatter
from rise_sdf_tpu_torch.ops.sphere_trace import sphere_trace

STEP, VARIANCE, N_RAYS = 20, 0.9, 128
EVAL_KEYS = ("comp_rgb_full", "comp_rgb_phys_full", "comp_diffuse_rgb",
             "comp_spec_rgb", "comp_spec_rgb_phys", "comp_diffuse_rgb_phys",
             "comp_blend", "comp_normal", "comp_albedo", "comp_metallic",
             "comp_roughness", "opacity", "depth")
EQUAL_KEYS = ("ray_included", "rays_valid", "num_samples",
              "stat_secondary_live")


def _fan(n, dtype=np.float32, origin=(0.0, 0.0, -4.0), spread=0.3):
    """``tests/test_sphere_trace.py``'s fan: ``n`` unit rays from
    ``origin`` towards the +z hemisphere."""
    o = np.tile(np.asarray([origin], np.float64), (n, 1))
    z = np.linspace(-spread, spread, n)
    d = np.stack([z * 0.5, z, np.ones_like(z)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(dtype), d.astype(dtype)


# --------------------------------------------------------------------- #
# the trace alone
# --------------------------------------------------------------------- #

TRACES = {  # name -> (rays, SDF scale, iterations)
    "sphere": (128, 1.0, 48), "non_unit": (64, 0.6, 96),
    "starved": (64, 0.05, 8)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(TRACES))
def test_trace_matches_jax(case, dtype):
    n, scale, iters = TRACES[case]
    o, d = _fan(n, np.dtype(dtype))
    with jax.enable_x64(dtype == "float64"):
        want = jax.jit(lambda o_, d_: jtrace(
            o_, d_,
            sdf_fn=lambda p: scale * (jnp.linalg.norm(p, axis=-1) - 0.5),
            aabb_min=jnp.full(3, -1.5, dtype), aabb_max=jnp.full(3, 1.5,
                                                                 dtype),
            n_iters=iters))(o, d)
        want = {f: np.asarray(getattr(want, f)) for f in want._fields}
    tdt = getattr(torch, dtype)
    got = sphere_trace(
        torch.from_numpy(o), torch.from_numpy(d),
        sdf_fn=lambda p: scale * (torch.linalg.vector_norm(p, dim=-1) - 0.5),
        aabb_min=torch.full((3,), -1.5, dtype=tdt),
        aabb_max=torch.full((3,), 1.5, dtype=tdt), n_iters=iters)
    got = {f: getattr(got, f).numpy() for f in got._fields}
    for f in ("hit", "converged"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    hit = want["hit"]
    for f in ("t_hit", "sdf_last", "sdf_min"):
        assert got[f].dtype == np.dtype(dtype)
        np.testing.assert_allclose(got[f][hit], want[f][hit], rtol=0,
                                   atol=1e-6, err_msg=f)
        np.testing.assert_allclose(
            got[f], want[f], rtol=0, atol=1e-6 if dtype == "float64"
            else 1e-4, err_msg=f)
    if case == "starved":
        assert not hit.any() and not want["converged"].any()
    else:
        assert 0 < hit.sum() < n and want["converged"].all()


# --------------------------------------------------------------------- #
# forward_surface and forward_surface_multi
# --------------------------------------------------------------------- #

# (occupancy, clearance, relighting): each value of each factor at least
# once; full and shell share a JAX compile, absent skips the guard
CASES = [("full", 4.0, False), ("shell", 4.0, False), ("full", 0.0, False),
         ("shell", 0.0, False), ("absent", 4.0, False),
         ("full", 4.0, True), ("shell", 4.0, True)]


@pytest.fixture(scope="module")
def pair():
    """The tiny split model in both packages on the JAX init (seed 0,
    drawn under ``jax.jit``)."""
    jcfg = jtiny()
    jcfg["model"]["variance"]["init_val"] = VARIANCE
    jm = jmodels.make(jcfg.model.name, jcfg.model)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = presets.tiny_split_config()["model"]
    cfg["variance"]["init_val"] = VARIANCE
    tm = models.make(cfg["name"], cfg)
    tm.load_state_dict(bridge.from_jax_params(bridge.flatten_params(params)),
                       strict=True)
    tm.requires_grad_(False)
    return jm, params, tm


def _occupancies(tm):
    """Full, the shell ``|sdf| < 2 cells`` of the init's SDF at the cell
    centres (a converged grid's shape), and absent; the same arrays go to
    both packages."""
    res = tm.grid_resolution
    g = (np.arange(res) + 0.5) / res * 2 * tm.radius - tm.radius
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    centres = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    sdf = tm.geometry.sdf(torch.from_numpy(centres), STEP).numpy()
    return {"full": np.ones(res ** 3, bool),
            "shell": np.abs(sdf) < 2 * 2 * tm.radius / res, "absent": None}


@pytest.fixture(scope="module")
def surface(pair):
    """The JAX renders of every case (one jit per graph), the port's
    model and the shared inputs."""
    jm, params, tm = pair
    occs = _occupancies(tm)
    o, d = _fan(N_RAYS)
    rays = jnp.asarray(np.concatenate([o, d], -1))
    step = jnp.asarray(STEP, jnp.int32)
    jmips = jm.emitter.build_mips(params["emitter"])
    # a second light: the learned one brightened and channel-rolled
    base1 = jnp.roll(params["emitter"]["base"] * 1.7 + 0.05, 1, -1)
    jmips1 = jm.emitter.build_mips({**params["emitter"], "base": base1})
    want, fns = {}, {}
    for occ, clear, relight in CASES:
        key = (occ == "absent", clear, relight)
        if key not in fns:
            jm.st_sdf_clearance = clear  # read when the jit traces below
            fns[key] = jax.jit(lambda p, r, o_, m, relight=relight:
                               jm.forward_surface(
                                   p, r, occ_binary=o_, mips=m, step=step,
                                   stage=1, relighting=relight,
                                   background_color=jnp.ones((3,))))
        want[occ, clear, relight] = {k: np.asarray(v) for k, v in fns[key](
            params, rays, occs[occ], jmips).items()}
    jm.st_sdf_clearance = 4.0
    multi = jax.jit(lambda p, r, o_, m0, m1: jm.forward_surface_multi(
        p, r, occ_binary=o_, mips_list=[m0, m1], step=step,
        relight_flags=(False, True), stage=1,
        background_color=jnp.ones((3,))))
    for occ in ("full", "shell"):
        want["multi", occ] = [{k: np.asarray(v) for k, v in o_.items()}
                              for o_ in multi(params, rays, occs[occ],
                                              jmips, jmips1)]
    return {"want": want, "tm": tm, "rays": torch.from_numpy(np.array(rays)),
            "occs": occs, "base1": torch.from_numpy(np.array(base1))}


def _check(got, want, what):
    for k in EQUAL_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k],
                                      err_msg=f"{what}: {k}")
    np.testing.assert_array_equal(got["opacity"].numpy() > 0.5,
                                  want["opacity"] > 0.5, err_msg=what)
    for k in EVAL_KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-4, err_msg=f"{what}: {k}")
    hit = want["opacity"][:, 0] > 0.5
    # misses are the background exactly
    np.testing.assert_allclose(got["comp_rgb_full"].numpy()[~hit], 1.0,
                               rtol=0, atol=1e-5, err_msg=what)
    return hit


@pytest.mark.parametrize("occ,clear,relight", CASES,
                         ids=[f"{o}-clear{c:g}-{'relight' if r else 'learned'}"
                              for o, c, r in CASES])
def test_forward_surface_matches_jax(surface, occ, clear, relight):
    tm = surface["tm"]
    tm.st_sdf_clearance = clear
    occ_t = surface["occs"][occ]
    before = scatter.scatter_add.launches
    got = tm.forward_surface(
        surface["rays"], occ_binary=None if occ_t is None
        else torch.from_numpy(occ_t), mips=tm.emitter.build_mips(),
        step=STEP, stage=1, relighting=relight,
        background_color=torch.ones(3))
    assert scatter.scatter_add.launches == before
    assert "stat_live" not in got and "stat_vis" not in got
    hit = _check(got, surface["want"][occ, clear, relight],
                 f"{occ}, clearance {clear}, relighting {relight}")
    inc = got["ray_included"].numpy()
    assert 0 < hit.sum() < N_RAYS and not inc.all()
    if occ != "full":
        assert inc[hit].all()  # the guard passes hits behind their shell
    elif clear == 0.0:
        assert not inc[~hit].any()  # every miss crossed occupied cells


@pytest.mark.parametrize("occ", ["full", "shell"])
def test_forward_surface_multi_matches_jax(surface, occ):
    tm = surface["tm"]
    tm.st_sdf_clearance = 4.0
    mips = [tm.emitter.build_mips(), tm.emitter.build_mips(surface["base1"])]
    outs = tm.forward_surface_multi(
        surface["rays"], occ_binary=torch.from_numpy(surface["occs"][occ]),
        mips_list=mips, step=STEP, relight_flags=(False, True), stage=1,
        background_color=torch.ones(3))
    wants = surface["want"]["multi", occ]
    for j, (got, want) in enumerate(zip(outs, wants)):
        if j:  # the calibration statistic rides on output 0 only
            assert "stat_secondary_live" not in got
            got = {**got, "stat_secondary_live": outs[0][
                "stat_secondary_live"]}
            want = {**want, "stat_secondary_live": wants[0][
                "stat_secondary_live"]}
        _check(got, want, f"{occ}, light {j}")
    lights = np.abs(wants[0]["comp_rgb_phys_full"]
                    - wants[1]["comp_rgb_phys_full"]).max()
    assert lights > 1e-3
    with pytest.raises(ValueError):
        tm.forward_surface_multi(
            surface["rays"], occ_binary=None, mips_list=mips, step=STEP,
            relight_flags=(False,), background_color=torch.ones(3))


# --------------------------------------------------------------------- #
# the system: surface chunks and the residual re-render
# --------------------------------------------------------------------- #

STARVED = {"sphere_trace_iters": 1, "sphere_trace_refine_iters": 0}
# "overflow": the residual's buffer cut to 8 slots per ray (2 x
# eval_samples_per_ray), so that its volumetric re-render drops rays
SYSTEMS = {"starved": STARVED, "guard": {},
           "overflow": {**STARVED, "eval_samples_per_ray": 4}}
# the JAX model's attributes of those keys
JAX_ATTRS = {"sphere_trace_iters": "st_iters",
             "sphere_trace_refine_iters": "st_refine"}


def _config(cfg, name):
    cfg["model"]["eval_mode"] = "sphere_trace"
    cfg["model"]["variance"]["init_val"] = VARIANCE
    cfg["model"].update(SYSTEMS[name])
    return cfg


def _split64(system):
    split = system.datamodule.val()
    split.directions = np.asarray(split.directions, np.float64)
    split.all_c2w = np.asarray(split.all_c2w, np.float64)
    return split


@pytest.fixture(scope="module")
def renders(pair, tmp_path_factory):
    """View 0 of the validation split through both packages' split
    systems in surface mode (``render_image``), for each of ``SYSTEMS``,
    on the JAX init at step 20 with a fully occupied grid (the init's).
    One JAX system serves both: its model takes each case's trace
    settings and drops its compiled surface chunk (the volumetric
    residual's chunk does not read them)."""
    tmp = tmp_path_factory.mktemp("surface_systems")
    _, params, _ = pair
    jcfg = _config(jtiny(), "guard")
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                         save_dir=str(tmp / "jax"))
    res = jsys.model.grid_resolution
    with jax.enable_x64():
        jstate64 = {"params": jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params),
            "occ_binary": jnp.ones(res ** 3, bool),
            "step": jnp.asarray(STEP, jnp.int32)}
    out, default = {}, {a: getattr(jsys.model, a) for a in JAX_ATTRS.values()}
    capacity = jsys.eval_capacity
    for name in SYSTEMS:
        for key, attr in JAX_ATTRS.items():
            setattr(jsys.model, attr, SYSTEMS[name].get(key, default[attr]))
        jsys.eval_capacity = jsys.eval_chunk * SYSTEMS[name][
            "eval_samples_per_ray"] if "eval_samples_per_ray" in SYSTEMS[
                name] else capacity
        cache = getattr(jsys, "_render_chunk_cache", {})
        for k in [k for k, v in cache.items() if getattr(v, "_surface",
                                                         False)]:
            del cache[k]
        with jax.enable_x64():
            want = jsys.render_image(jstate64, _split64(jsys), 0, stage=1)
        cfg = _config(presets.tiny_split_config(), name)
        system = systems.make(
            cfg["system"]["name"], cfg,
            datasets.make(cfg["dataset"]["name"], cfg["dataset"]),
            save_dir=str(tmp / name), device="cpu")
        system.model.load_state_dict(bridge.from_jax_params(
            bridge.flatten_params(params)), strict=True)
        system.model.double()
        state = {"step": STEP, "occs": torch.zeros(res ** 3),
                 "occ_binary": torch.ones(res ** 3, dtype=torch.bool)}
        before = scatter.scatter_add.launches
        got = system.render_image(state, _split64(system), 0)
        out[name] = {"want": want, "got": got, "system": system,
                     "state": state, "residual": system.residual_rays,
                     "k1": scatter.scatter_add.launches - before}
    return out


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_surface_render_image_matches_jax(renders, name):
    r = renders[name]
    got, want = r["got"], r["want"]
    assert r["k1"] == 0
    assert sorted(got) == sorted(k for k in want if not k.startswith(
        "stat_"))
    np.testing.assert_array_equal(got["ray_included"], want["ray_included"])
    # the residual does not escalate: both packages drop the rays that
    # overflow its buffer and keep their partial render
    dropped = int((~got["ray_included"]).sum())
    assert (dropped > 0) == (name == "overflow")
    for k in got:
        if k != "ray_included":
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                       atol=1e-4, err_msg=k)
    n = got["ray_included"].size
    if name != "guard":
        assert r["residual"] == n
    else:
        assert 0 < r["residual"] < n


def test_residual_keeps_resolved_rows(renders):
    """The guard's partial residual on the central chunk of view 0:
    resolved rows bit-identical to the raw surface chunk, flagged rows
    re-rendered and included."""
    system, state = renders["guard"]["system"], renders["guard"]["state"]
    rays, _ = system.view_rays(_split64(system), 0)
    n = system.eval_chunk
    mid = rays.shape[0] // 2
    part = rays[mid - n // 2:mid + n // 2]
    with torch.no_grad(), system.frozen_params():
        ctx = system.eval_context(state)
        raw = system.render_chunk(state, part, **ctx)
        inc = raw["ray_included"]
        assert 0 < int(inc.sum()) < n
        assert "stat_secondary_live" in raw and "stat_live" not in raw
        res = {k: v for k, v in raw.items() if not k.startswith("stat_")}
        merged = system.complete_chunk(state, part, res, None, ctx, {})
    assert bool(merged["ray_included"].all())
    for k, v in res.items():
        assert torch.equal(merged[k][inc], v[inc]), k
        assert bool(torch.isfinite(merged[k].float()).all()), k
        if k in ("comp_rgb_full", "opacity"):
            assert not torch.equal(merged[k][~inc], v[~inc]), k


@pytest.mark.parametrize("kw", [{"capacity": 4096}, {"mult": 2}],
                         ids=["capacity", "mult2"])
def test_chunk_with_a_buffer_stays_volumetric(renders, kw):
    """The calibration probe's capacity and an escalation render
    volumetrically: the marching statistics are there, and the chunk
    equals the model's volumetric ``forward`` at that buffer."""
    system, state = renders["guard"]["system"], renders["guard"]["state"]
    assert not system.surface_chunk(**kw)
    rays, _ = system.view_rays(_split64(system), 0)
    part = rays[:system.eval_chunk]
    ctx = system.eval_context(state)
    with torch.no_grad():
        got = system.render_chunk(state, part, **kw, **ctx)
    assert "stat_live" in got and "stat_vis" in got
    model = system.model
    opts = model.eval_options(STEP, system.eval_chunk)
    opts["capacity"] = kw.get("capacity",
                              system.eval_capacity * kw.get("mult", 1))
    frac = None if "mult" not in kw else min(
        model.secondary_sample_capacity_frac * kw["mult"], 1.0)
    with torch.no_grad():
        want = model(part, occ_binary=state["occ_binary"], step=STEP,
                     bake=ctx["bake"], mips=ctx["mips"],
                     background_color=torch.ones(3),
                     secondary_frac=frac, **opts)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
