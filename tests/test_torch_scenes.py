"""Port parity: scenes read from disk and the procedural concave scene,
and the presets of the repo's two configs, against the JAX package on
the CPU.

- A tiny TensoIR-layout scene written here (PNGs by PIL, EXRs by the EXR
  writer): 2 views per split at 32x32, albedo and roughness as EXR and
  as PNG, two relight PNGs per view.  The JAX loader and the port's
  give bit-equal attributes at the native size, at ``img_wh`` 16x16 and
  at ``img_downscale`` 2 (the PNG resize is bit-equal to PIL's,
  ``tests/test_torch_readers.py``; its contract is 1 code value).
- A tiny Blender-layout scene with an RGBA, an RGB and a grey image:
  the same.
- ``synthetic-concave`` at 24x24 with 2 views, every split and the
  relight ground truth and its EXRs: bit-equal to the JAX split.
- ``split_mixed_occ_tensoir()`` and ``neus_blender()`` with
  ``dataset.scene=x`` against ``rise_sdf_tpu.config.load_config`` on the
  two yamls, section by section; the launcher's ``???`` error and its
  filling-in of ``name`` and ``dataset.root_dir``.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from rise_sdf_tpu import datasets as jdatasets
from rise_sdf_tpu.config import load_config
from rise_sdf_tpu_torch import datasets, launch, presets
from rise_sdf_tpu_torch.utils.exr import write_exr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
LIGHTS = ["warm", "bright"]


def _smooth(rng, h, w, c):
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([np.sin(xx / (2.0 + i) + i) * 70 + np.cos(yy / (3.0 + i))
                    * 50 + 128 + rng.integers(-30, 30, (h, w))
                    for i in range(c)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _rgba(rng):
    img = _smooth(rng, SIZE, SIZE, 4)
    img[:6, ..., 3] = 0  # background, and soft and hard edges
    img[6:12, ..., 3] = 255
    return img


def _c2w(rng):
    m = np.eye(4)
    m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    m[:3, 3] = rng.normal(size=3) * 2
    return m


@pytest.fixture(scope="module")
def tensoir_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tensoir")
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        for i in range(2):
            d = root / f"{split}_{i:03d}"
            d.mkdir()
            meta = {"cam_transform_mat": ",".join(
                f"{v:.9g}" for v in _c2w(rng).reshape(-1)),
                "cam_angle_x": 0.6911112070083618, "w": SIZE, "h": SIZE}
            (d / "metadata.json").write_text(json.dumps(meta))
            Image.fromarray(_rgba(rng), "RGBA").save(d / "rgba.png")
            for light in LIGHTS:
                Image.fromarray(_rgba(rng), "RGBA").save(
                    d / f"rgba_{light}.png")
            write_exr(str(d / "albedo.exr"), rng.random((SIZE, SIZE, 3)))
            write_exr(str(d / "roughness.exr"), rng.random((SIZE, SIZE, 3)))
            Image.fromarray(_rgba(rng), "RGBA").save(d / "albedo.png")
            Image.fromarray(_smooth(rng, SIZE, SIZE, 1)[..., 0], "L").save(
                d / "roughness.png")
            normal = rng.normal(size=(SIZE, SIZE, 4)).astype(np.float32)
            normal[..., 3] = rng.random((SIZE, SIZE))
            normal[:4, :, 3] = 0
            normal[4:8, :, 3] = 1
            write_exr(str(d / "normal.exr"), normal)
    return root


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("blender")
    rng = np.random.default_rng(1)
    for split in ("train", "test"):
        (root / split).mkdir()
        frames = []
        for i, mode in enumerate(("RGBA", "RGB", "L")):
            img = _rgba(rng)
            pil = Image.fromarray(img, "RGBA")
            pil.convert(mode).save(root / split / f"r_{i}.png")
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": _c2w(rng).tolist()})
        meta = {"camera_angle_x": 0.6911112070083618, "w": SIZE, "h": SIZE,
                "frames": frames}
        (root / f"transforms_{split}.json").write_text(json.dumps(meta))
    return root


ATTRS = ("all_c2w", "all_images", "all_fg_masks", "directions")
TENSOIR_ATTRS = ATTRS + ("all_normals", "all_albedo", "all_roughness")
SCALARS = ("w", "h", "img_wh", "near", "far", "focal", "has_mask",
           "apply_mask")


def _assert_same_split(got, want, attrs):
    for k in attrs:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in SCALARS:
        assert getattr(got, k) == getattr(want, k), k
    assert len(got) == len(want)


SIZES = {"native": {"img_wh": [SIZE, SIZE]}, "wh16": {"img_wh": [16, 16]},
         "downscale2": {"img_downscale": 2}}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("fmt", ["exr", "png"])
def test_tensoir_split_equals_jax(tensoir_root, fmt, size):
    cfg = {"name": "tensoir", "root_dir": str(tensoir_root),
           "near_plane": 2.0, "far_plane": 6.0, "openGL_camera": True,
           "relight_list": LIGHTS, "has_albedo": True,
           "albedo_format": fmt, "has_roughness": True,
           "roughness_format": fmt, **SIZES[size]}
    got_dm = datasets.make("tensoir", dict(cfg))
    want_dm = jdatasets.make("tensoir", dict(cfg))
    for split in ("train", "test"):
        got = getattr(got_dm, split)()
        want = getattr(want_dm, split)()
        _assert_same_split(got, want, TENSOIR_ATTRS)
        assert list(got.relight_images) == LIGHTS
        for light in LIGHTS:
            np.testing.assert_array_equal(got.relight_images[light],
                                          want.relight_images[light])
    # the reference's quirk: an EXR is not resized
    w, h = got.img_wh
    assert got.all_images.shape[1:3] == (h, w)
    assert got.all_normals.shape[1:3] == (SIZE, SIZE)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_blender_split_equals_jax(blender_root, size):
    cfg = {"name": "blender", "root_dir": str(blender_root),
           **SIZES[size]}
    for split in ("train", "test"):
        got = datasets.make("blender", dict(cfg)).split(split)
        want = jdatasets.make("blender", dict(cfg)).split(split)
        _assert_same_split(got, want, ATTRS)
        # RGB and grey frames are opaque
        assert (got.all_fg_masks[1:] == 1).all()
        assert (got.all_fg_masks[0] < 1).any()


@pytest.mark.parametrize("split", ["train", "test"])
def test_concave_scene_equals_jax(tmp_path, split):
    cfg = {"name": "synthetic-concave", "img_wh": [24, 24], "n_images": 2,
           "relight_list": ["warm", "bright"]}
    got = datasets.make("synthetic-concave", dict(
        cfg, hdr_filepath=str(tmp_path / "port"))).split(split)
    want = jdatasets.make("synthetic-concave", dict(
        cfg, hdr_filepath=str(tmp_path / "jax"))).split(split)
    attrs = ATTRS + ("all_normals", "all_albedo", "all_roughness")
    for k in attrs:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert got.shape == want.shape == "concave"
    assert got.env_name == want.env_name == "bright"
    assert got.focal == want.focal
    assert sorted(got.relight_images) == sorted(want.relight_images)
    for light, img in want.relight_images.items():
        np.testing.assert_array_equal(got.relight_images[light], img)
        assert (tmp_path / "port" / f"{light}.exr").read_bytes() == (
            tmp_path / "jax" / f"{light}.exr").read_bytes()
    # the scene fills a good part of the frame, not all of it
    assert 0.2 < got.all_fg_masks.mean() < 0.9


def _plain(node):
    if hasattr(node, "items"):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


@pytest.mark.parametrize("preset,yaml", [
    ("split_mixed_occ_tensoir", "configs/split-mixed-occ-tensoir.yaml"),
    ("neus_blender", "configs/neus-blender.yaml")])
def test_config_presets_equal_the_yamls(preset, yaml):
    got = launch.resolve(launch.apply_overrides(getattr(presets, preset)(),
                                                ["dataset.scene=x"]))
    want = _plain(load_config(os.path.join(REPO, yaml),
                              cli_args=["dataset.scene=x"]))
    assert set(got) == set(want)
    for section in sorted(want):
        assert got[section] == want[section], section
    assert got["dataset"]["root_dir"] == "./load/TensoIR_Synthetic/x"
    assert got["name"].endswith("-x")


def test_flagship_presets_share_the_tensoir_config():
    whole = presets.split_mixed_occ_tensoir()
    train = presets.split_mixed_occ_train_full()
    for section in set(whole) - {"name", "dataset"}:
        assert train[section] == whole[section], section
    assert presets.neus_blender()["model"] == \
        presets.neus_sphere_full()["model"]


@pytest.mark.parametrize("preset", ["split_mixed_occ_tensoir",
                                    "neus_blender"])
def test_launcher_requires_the_scene(tmp_path, preset):
    with pytest.raises(ValueError, match="dataset.scene"):
        launch.main(["--preset", preset, "--train", "--device", "cpu",
                     "--exp_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_launcher_fills_the_scene_in(tmp_path, blender_root):
    """``name`` and ``root_dir`` take the scene after the overrides: the
    trial directory is named after it, and the loader looks for the
    scene under ``load/``, or under an overridden root."""
    exp = tmp_path / "exp"
    with pytest.raises(FileNotFoundError, match="TensoIR_Synthetic/lego"):
        launch.main(["--preset", "neus_blender", "--train", "--device",
                     "cpu", "--exp_dir", str(exp), "dataset.scene=lego"])
    (parsed,) = exp.glob("neus-blender-lego/@*/config/parsed.json")
    cfg = json.loads(parsed.read_text())
    assert cfg["name"] == "neus-blender-lego"
    assert cfg["dataset"]["root_dir"] == "./load/TensoIR_Synthetic/lego"
    cfg = launch.resolve(launch.apply_overrides(presets.neus_blender(), [
        "dataset.scene=r", f"dataset.root_dir={blender_root}",
        f"dataset.img_wh=[{SIZE},{SIZE}]"]))
    assert cfg["name"] == "neus-blender-r"
    split = datasets.make(cfg["dataset"]["name"], cfg["dataset"]).train()
    assert split.img_wh == (SIZE, SIZE) and len(split) == 3
