"""Mesh and material export of the port (``ops/mcubes.py``,
``export.py``, ``utils/saving.py``, the systems' ``export``) against the
JAX package.

* Marching tetrahedra on JAX's own level grid gives JAX's faces exactly
  and its vertices within 1e-6: a sphere, an empty field, a full field,
  a random field from a numpy seed.
* ``forward_level`` on a 24^3 grid at the tiny configs within 1e-5.
* The vertex normals (the configured gradient: analytic for NeuS, plain
  finite differences for the split config, as JAX's ``export_mesh``
  takes them) and the baked attributes (NeuS: the radiance along
  -normal; split: albedo, metallic, roughness at stage 1), evaluated by
  both packages at JAX's exported vertices, within 1e-5.
* The PLY the port writes reads back through JAX's ``load_ply``.
* ``SplitOccSystem.test(export=True)`` writes the PLY and the three
  ``.npy`` files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu import presets as jpresets
from rise_sdf_tpu import systems as jsystems
from rise_sdf_tpu.export import export_mesh as jax_export_mesh
from rise_sdf_tpu.ops.mcubes import marching_tets as jax_marching_tets
from rise_sdf_tpu.utils.saving import load_ply as jax_load_ply
from rise_sdf_tpu_torch import datasets, presets, systems
from rise_sdf_tpu_torch.export import bake_attributes
from rise_sdf_tpu_torch.ops.mcubes import marching_tets
from rise_sdf_tpu_torch.utils.saving import load_ply, write_ply

STEP = 14  # stage 1 of the tiny split config; every hash level open


def _fields():
    c = np.linspace(-1, 1, 33, dtype=np.float32)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    rng = np.random.default_rng(3)
    return {"sphere": np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6,
            "empty": np.ones((9, 10, 11)),
            "full": -np.ones((9, 10, 11)),
            "random": rng.standard_normal((13, 17, 19))}


@pytest.mark.parametrize("threshold", [0.0, 0.2])
@pytest.mark.parametrize("name", ["sphere", "empty", "full", "random"])
def test_marching_tets_matches_jax(name, threshold):
    level = _fields()[name].astype(np.float32)
    vj, fj = jax_marching_tets(level, threshold)
    vt, ft = marching_tets(torch.from_numpy(level), threshold)
    assert ft.dtype == torch.int64 and vt.dtype == torch.float32
    np.testing.assert_array_equal(ft.numpy(), fj)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=1e-6)
    if name in ("sphere", "random"):
        assert len(fj) > 1000
    else:
        assert len(fj) == 0


@pytest.fixture(scope="module", params=["neus", "split"])
def pair(request, tmp_path_factory):
    """The JAX system with fresh params at ``STEP`` and the port system
    loaded from its checkpoint."""
    tmp = str(tmp_path_factory.mktemp("export"))
    if request.param == "neus":
        jcfg, cfg = jpresets.tiny_neus_config(), presets.tiny_neus_config()
    else:
        jcfg, cfg = jpresets.tiny_split_config(), presets.tiny_split_config()
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jdatasets.make(jcfg.dataset.name, jcfg.dataset),
                         save_dir=os.path.join(tmp, "jax"))
    jstate = jsys.init_state(0)
    jstate["step"] = jnp.asarray(STEP, jnp.int32)
    path = jsys.save_checkpoint(jstate, os.path.join(tmp, "j.ckpt.npz"))
    tsys = systems.make(cfg["system"]["name"], cfg,
                        datasets.make(cfg["dataset"]["name"], cfg["dataset"]),
                        save_dir=os.path.join(tmp, "torch"), device="cpu")
    tstate = tsys.load_checkpoint(path)
    return request.param, jsys, jstate, tsys, tstate, tmp


def test_forward_level_matches_jax(pair):
    _, jsys, jstate, tsys, _, _ = pair
    c = np.linspace(-1.5, 1.5, 24, dtype=np.float32)
    pts = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    want = jax.jit(lambda p: jsys.model.forward_level(
        jstate["params"], p, STEP))(jnp.asarray(pts))
    got = tsys.model.forward_level(torch.from_numpy(pts), STEP)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def jax_mesh(pair):
    _, jsys, jstate, _, _, _ = pair
    mesh = jax_export_mesh(jsys.model, jstate, jsys.config)
    assert mesh is not None and len(mesh["t_pos_idx"]) > 100
    return mesh


def test_attributes_at_jax_vertices_match_jax(pair, jax_mesh):
    kind, jsys, jstate, tsys, _, _ = pair
    verts = jax_mesh["v_pos"]
    geo = jax.jit(lambda p: jsys.model.geometry.forward(
        jstate["params"]["geometry"], p, STEP, with_grad=True,
        with_feature=False))(jnp.asarray(verts))
    nj = np.asarray(geo["grad"])
    nj = nj / np.maximum(np.linalg.norm(nj, axis=-1, keepdims=True), 1e-6)
    x = torch.from_numpy(verts)
    with tsys.frozen_params():
        nt = tsys.model.geometry(x, STEP, with_grad=True,
                                 with_feature=False)["grad"].detach()
        got = bake_attributes(tsys.model, STEP, x, tsys.config["export"])
    nt = nt / torch.clamp(torch.linalg.vector_norm(nt, dim=-1, keepdim=True),
                          min=1e-6)
    np.testing.assert_allclose(nt.numpy(), nj, rtol=0, atol=1e-5)
    keys = ["v_rgb"] + (["albedo", "metallic", "roughness"]
                        if kind == "split" else [])
    assert sorted(got) == sorted(keys)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), jax_mesh[k], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_port_ply_reads_back_through_jax(tmp_path):
    rng = np.random.default_rng(0)
    verts = rng.standard_normal((50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (80, 3))
    for colors in (None, rng.random((50, 3))):
        path = str(tmp_path / "m.ply")
        write_ply(path, verts, faces, colors)
        for reader in (jax_load_ply, load_ply):
            v, f = reader(path)
            np.testing.assert_array_equal(v, verts)
            np.testing.assert_array_equal(f, faces)


def test_split_test_exports_mesh_and_materials(tmp_path):
    cfg = presets.tiny_split_test_config(str(tmp_path / "env"))
    cfg["dataset"]["n_images"] = 1
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=str(tmp_path / "save"), device="cpu")
    state = system.init_state(0)
    state["step"] = STEP
    system.test(state)
    iso = cfg["model"]["geometry"]["isosurface"]
    save = tmp_path / "save"
    verts, faces = load_ply(str(save / f"it{STEP}-mc{iso['resolution']}.ply"))
    assert len(faces) > 100 and np.abs(verts).max() <= 1.5
    assert faces.max() < len(verts)
    for k in ("albedo", "metallic", "roughness"):
        a = np.load(save / f"{k}.npy")
        assert a.shape[0] == len(verts) and np.isfinite(a).all()
        assert a.min() >= 0.0 and a.max() <= 1.0
    assert (save / f"it{STEP}-test" / "0.png").exists()
