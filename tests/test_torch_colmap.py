"""Port parity for the COLMAP loader (``datasets/colmap_utils.py``,
``datasets/colmap.py``) against the JAX package's, on captures this
file writes in COLMAP's binary layout (``images/``, optional
``masks/``, ``sparse/0/{cameras,images,points3D}.bin``) with PIL.

The readers, ``qvec2rotmat`` and ``ransac_plane`` are bit-equal to
JAX's; ``normalize_poses`` is held at 1e-6 (both sides run the same
float64 numpy, so it is in fact exact); the splits' images, masks,
directions and poses are bit-equal to JAX's ``ColmapSplit`` (whose
images PIL reads and resizes), for every camera model the JAX loader
reads, without masks and with masks under both name forms.  The predict
trajectory is held at 1e-6.  A capture of JPEG images and masks (grey,
4:4:4, 4:2:2 and 4:2:0, with and without restart intervals) is read
bit-equal to JAX's; a progressive JPEG raises ``ValueError`` naming the
file in the port."""

import os
import struct

import numpy as np
import pytest
from PIL import Image

from rise_sdf_tpu.datasets import colmap as jcolmap
from rise_sdf_tpu.datasets import colmap_utils as jutils
from rise_sdf_tpu_torch import datasets
from rise_sdf_tpu_torch.datasets import colmap, colmap_utils

MODELS = {"SIMPLE_PINHOLE": (0, [20.0, 12.0, 8.0]),
          "PINHOLE": (1, [20.0, 21.0, 12.5, 7.5]),
          "SIMPLE_RADIAL": (2, [19.0, 11.5, 8.25, 0.01]),
          "OPENCV": (4, [20.0, 19.5, 12.0, 8.0, 0.01, -0.02, 0.001,
                         0.002])}
W, H, N_VIEWS = 24, 16, 9


def write_cameras(path, cam_id, model_id, w, h, params):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", cam_id, model_id, w, h))
        f.write(struct.pack(f"<{len(params)}d", *params))


def write_images(path, metas):
    """``metas``: (image_id, qvec, tvec, camera_id, name, xys, point ids)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(metas)))
        for image_id, q, t, cam_id, name, xys, ids in metas:
            f.write(struct.pack("<idddddddi", image_id, *q, *t, cam_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(ids)))
            for (x, y), pid in zip(xys, ids):
                f.write(struct.pack("<ddq", x, y, pid))


def write_points(path, xyz, rgb):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(struct.pack("<QdddBBBd", i + 1, *p, *c, 0.5))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<iiii", 1, i, 2, i))


def random_qvec(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return q * np.sign(q[0])


_Q = np.array([0.96, 0.2, -0.1, 0.15])
TILT = jutils.qvec2rotmat(_Q / np.linalg.norm(_Q))  # its z: the ground's


def scene_points(rng, n_ground=160, n_object=60):
    """A ground plane (z = -0.4 in the ``TILT`` frame) and points above
    it."""
    g = np.concatenate([rng.uniform(-2, 2, (n_ground, 2)),
                        np.full((n_ground, 1), -0.4)], 1)
    o = rng.normal(scale=0.3, size=(n_object, 3))
    o[:, 2] = np.abs(o[:, 2])
    return np.concatenate([g, o]) @ TILT.T + np.array([0.3, -0.2, 0.5])


def ring_poses(n, seed):
    """n world-to-camera (qvec, tvec) on a noisy ring looking inwards."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([3 * np.cos(a), 3 * np.sin(a), 1.5]) \
            + 0.05 * rng.normal(size=3)
        fwd = -eye / np.linalg.norm(eye)           # camera +z (COLMAP)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        r_c2w = np.stack([right, down, fwd], 1)
        r_w2c = r_c2w.T
        out.append((rotmat2qvec(r_w2c), -r_w2c @ eye))
    return out


def rotmat2qvec(r):
    """Unit (w, x, y, z) of a rotation matrix, w >= 0 (COLMAP's
    ``rotmat2qvec``)."""
    r = np.asarray(r).T
    k = np.array([
        [r[0, 0] - r[1, 1] - r[2, 2], 0, 0, 0],
        [r[1, 0] + r[0, 1], r[1, 1] - r[0, 0] - r[2, 2], 0, 0],
        [r[2, 0] + r[0, 2], r[2, 1] + r[1, 2], r[2, 2] - r[0, 0] - r[1, 1],
         0],
        [r[1, 2] - r[2, 1], r[2, 0] - r[0, 2], r[0, 1] - r[1, 0],
         r[0, 0] + r[1, 1] + r[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * (1 if q[0] >= 0 else -1)


# PIL JPEG settings of the JPEG captures, one per view in turn
JPEG_KINDS = [{"subsampling": 2, "quality": 90},
              {"subsampling": 0, "quality": 75, "restart_marker_blocks": 3},
              {"quality": 95},
              {"subsampling": 1, "quality": 50, "restart_marker_rows": 1,
               "optimize": True}]


def _save(img, path, jpeg, i):
    if jpeg is None:
        img.save(path)
    elif jpeg == "all":
        img.save(path, "JPEG", **JPEG_KINDS[i % len(JPEG_KINDS)])
    else:
        img.save(path, "JPEG", **jpeg)


def write_capture(root, model="PINHOLE", masks=None, seed=0, jpeg=None):
    """A capture of ``N_VIEWS`` W x H images (RGB, RGBA and grey PNGs in
    turn) under ``root``; ``masks``: None, or "both" (grey and RGB mask
    PNGs, every other one under the name without its first three
    characters).  ``jpeg="all"``: every image and mask a JPEG instead
    (RGB, RGB and grey in turn, in the ``JPEG_KINDS`` settings); a dict:
    image 4 a JPEG written with those PIL settings."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "sparse", "0"))
    if masks:
        os.makedirs(os.path.join(root, "masks"))
    model_id, params = MODELS[model]
    write_cameras(os.path.join(root, "sparse/0/cameras.bin"), 1, model_id,
                  W, H, params)
    pts = scene_points(rng)
    write_points(os.path.join(root, "sparse/0/points3D.bin"), pts,
                 rng.integers(0, 256, (len(pts), 3)))
    metas = []
    for i, (q, t) in enumerate(ring_poses(N_VIEWS, seed)):
        name = f"img{i:03d}.png"
        mode = ("RGB", "RGBA", "L")[i % 3]
        c = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
        px = rng.integers(0, 256, (H, W, c), dtype=np.uint8)
        every = jpeg == "all"
        if every or (jpeg and i == 4):
            name = f"img{i:03d}.jpg"
            _save(Image.fromarray(px[..., :3] if c >= 3 else px[..., 0]),
                  os.path.join(root, "images", name), jpeg, i)
        else:
            Image.fromarray(px if c > 1 else px[..., 0], mode).save(
                os.path.join(root, "images", name))
        if masks:
            m = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            img = Image.fromarray(m[..., 0], "L") if i % 2 \
                else Image.fromarray(m, "RGB")
            _save(img, os.path.join(root, "masks",
                                    name if i % 4 < 2 else name[3:]),
                  "all" if every else None, i + 1)
        metas.append((i + 1, q, t, 1, name, rng.uniform(0, W, (3, 2)),
                      [1, 2, -1]))
    # COLMAP's images.bin order is not the id order
    write_images(os.path.join(root, "sparse/0/images.bin"), metas[::-1])
    return pts


@pytest.mark.parametrize("model", sorted(MODELS))
def test_readers_are_bit_equal(tmp_path, model):
    write_capture(str(tmp_path), model)
    sparse = os.path.join(str(tmp_path), "sparse", "0")
    for fn in ("read_cameras_binary", "read_images_binary",
               "read_points3d_binary"):
        ext = {"read_cameras_binary": "cameras",
               "read_images_binary": "images",
               "read_points3d_binary": "points3D"}[fn]
        path = os.path.join(sparse, f"{ext}.bin")
        got, want = getattr(colmap_utils, fn)(path), getattr(jutils, fn)(path)
        assert list(got) == list(want)
        for k in want:
            for a, b in zip(got[k], want[k]):
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b
    cams = colmap_utils.read_cameras_binary(os.path.join(sparse,
                                                         "cameras.bin"))
    assert cams[1].model == model and cams[1].width == W


def test_qvec2rotmat_and_ransac_plane_are_bit_equal():
    rng = np.random.default_rng(3)
    for _ in range(8):
        q = random_qvec(rng)
        r = colmap_utils.qvec2rotmat(q)
        np.testing.assert_array_equal(r, jutils.qvec2rotmat(q))
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(rotmat2qvec(r), q, atol=1e-9)
    pts = scene_points(rng).astype(np.float32)
    for seed in (0, 5):
        got = colmap_utils.ransac_plane(pts, 0.01, seed=seed)
        np.testing.assert_array_equal(got, jutils.ransac_plane(pts, 0.01,
                                                               seed=seed))
    # the ground's normal: the tilted frame's z
    assert abs(got[:3] @ TILT[:, 2]) == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("center", ["camera", "lookat", "point"])
@pytest.mark.parametrize("up", ["camera", "ground"])
def test_normalize_poses_matches_jax(center, up):
    rng = np.random.default_rng(7)
    c2w = []
    for q, t in ring_poses(N_VIEWS, 2):
        r = jutils.qvec2rotmat(q)
        m = np.concatenate([r.T, -r.T @ t.reshape(3, 1)], 1)
        m[:, 1:3] *= -1.0
        c2w.append(m.astype(np.float32))
    poses = np.stack(c2w)
    pts = scene_points(rng).astype(np.float32)
    got = colmap.normalize_poses(poses, pts, up, center)
    want = jcolmap.normalize_poses(poses, pts, up, center)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    # the nearest camera at distance 1
    assert np.linalg.norm(got[0][:, :, 3], axis=-1).min() == \
        pytest.approx(1.0, abs=1e-6)
    traj = colmap.create_spheric_poses(got[0][:, :, 3], 7)
    np.testing.assert_allclose(
        traj, jcolmap.create_spheric_poses(want[0][:, :, 3], 7), atol=1e-6)


def _config(root, **kw):
    return dict({"root_dir": root, "img_downscale": 2,
                 "up_est_method": "ground", "center_est_method": "lookat",
                 "n_test_traj_steps": 5, "apply_mask": True}, **kw)


@pytest.mark.parametrize("masks", [None, "both"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_splits_are_bit_equal_to_jax(tmp_path, model, masks):
    root = str(tmp_path)
    write_capture(root, model, masks, seed=len(model))
    cfg = _config(root)
    dm = datasets.make("colmap", cfg)
    for name in ("train", "test", "predict"):
        got = getattr(dm, name)()
        want = jcolmap.ColmapSplit(dict(cfg), name)
        assert (got.w, got.h) == (want.w, want.h) == (W // 2, H // 2)
        assert got.has_mask == want.has_mask == bool(masks)
        assert got.apply_mask == want.apply_mask
        assert len(got) == len(want) == {"train": 7, "test": 2,
                                         "predict": 5}[name]
        tol = {"rtol": 1e-6, "atol": 1e-6} if name == "predict" else {}
        for k in ("directions", "all_c2w", "all_images", "all_fg_masks",
                  "pts3d"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if tol:
                np.testing.assert_allclose(a, b, err_msg=k, **tol)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        assert (got.near, got.far) == (want.near, want.far)
    val = dm.val()
    np.testing.assert_array_equal(val.all_images, dm.train().all_images)


def test_img_wh_and_full_size(tmp_path):
    root = str(tmp_path)
    write_capture(root, "PINHOLE")
    for kw in ({"img_wh": [W, H]}, {"img_wh": [12, 8]},
               {"img_downscale": 1}):
        cfg = {k: v for k, v in _config(root).items() if k != "img_downscale"}
        cfg.update(kw)
        got = colmap.ColmapSplit(cfg, "train")
        want = jcolmap.ColmapSplit(dict(cfg), "train")
        np.testing.assert_array_equal(got.all_images, want.all_images)
        np.testing.assert_array_equal(got.directions, want.directions)
    with pytest.raises(ValueError, match="aspect"):
        colmap.ColmapSplit(dict(_config(root), img_wh=[12, 12]), "train")


@pytest.mark.parametrize("masks", [None, "both"])
def test_jpeg_capture_is_bit_equal_to_jax(tmp_path, masks):
    root = str(tmp_path)
    write_capture(root, "SIMPLE_RADIAL", masks, seed=3, jpeg="all")
    assert sorted(os.listdir(os.path.join(root, "images")))[0] == \
        "img000.jpg"
    cfg = _config(root)
    for name in ("train", "test"):
        got = colmap.ColmapSplit(cfg, name)
        want = jcolmap.ColmapSplit(dict(cfg), name)
        for k in ("all_images", "all_fg_masks"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    # at the stored size too: the decoded bytes themselves
    cfg = dict(cfg, img_downscale=1)
    np.testing.assert_array_equal(
        colmap.ColmapSplit(cfg, "train").all_images,
        jcolmap.ColmapSplit(dict(cfg), "train").all_images)


def test_jpeg_raises_value_error(tmp_path):
    """A JPEG kind the port does not read (progressive) raises
    ``ValueError`` naming the file; the JAX loader reads it with PIL."""
    root = str(tmp_path)
    write_capture(root, "PINHOLE", jpeg={"progressive": True})
    assert len(jcolmap.ColmapSplit(_config(root), "train")) == 7
    with pytest.raises(ValueError, match=r"img004\.jpg.*progressive"):
        colmap.ColmapSplit(_config(root), "train")
    # the predict split reads no image
    assert len(colmap.ColmapSplit(_config(root), "predict")) == 5
    # neither PNG nor JPEG
    with open(os.path.join(root, "images", "img004.jpg"), "wb") as f:
        f.write(b"GIF89a" + bytes(32))
    with pytest.raises(ValueError, match=r"img004\.jpg.*PNG and JPEG"):
        colmap.ColmapSplit(_config(root), "train")


def test_grey_and_rgb_conversions_match_pil():
    rng = np.random.default_rng(11)
    for c, mode in ((1, "L"), (2, "LA"), (3, "RGB"), (4, "RGBA")):
        px = rng.integers(0, 256, (5, 7, c), dtype=np.uint8)
        img = Image.fromarray(px[..., 0] if c == 1 else px, mode)
        np.testing.assert_array_equal(colmap.to_rgb(px),
                                      np.asarray(img.convert("RGB")))
        np.testing.assert_array_equal(colmap.to_grey(px)[..., 0],
                                      np.asarray(img.convert("L")))


def test_learned_background_eval_on_a_capture_matches_jax(tmp_path):
    """The tiny NeuS system with a learned background at radius 0.5 on a
    written capture, JAX's params in both: the test view and the first
    predict frame rendered by the port's ``render_image`` against JAX's
    (1e-4, the float32 scan's rounding; ``tests/test_torch_neus.py``),
    then the port's ``validate``, ``test`` and ``predict`` write their
    images (``predict`` one per trajectory pose)."""
    import torch

    from rise_sdf_tpu import presets as jpresets
    from rise_sdf_tpu import systems as jsystems
    from rise_sdf_tpu_torch import presets, systems

    root = str(tmp_path / "capture")
    write_capture(root, "PINHOLE")
    data = _config(root, n_test_traj_steps=3, apply_mask=False,
                   name="colmap")
    small = {"radius": 0.5, "geometry": {"radius": 0.5},
             "geometry_bg": {"radius": 0.5}}
    jcfg = jpresets.tiny_neus_config()
    jcfg.model.merge(presets.TINY_BACKGROUND)
    jcfg.model.merge(small)
    jcfg.system.optimizer.params.merge(presets.BACKGROUND_LR)
    jcfg["dataset"] = dict(data)
    jsys = jsystems.make(jcfg.system.name, jcfg,
                         jcolmap.ColmapDataModule(dict(data)),
                         save_dir=str(tmp_path / "jax"))
    jstate = jsys.init_state(0)
    path = jsys.save_checkpoint(jstate, str(tmp_path / "jax.ckpt.npz"))
    cfg = presets.tiny_neus_colmap_config()
    cfg["model"].update(radius=0.5)
    for k in ("geometry", "geometry_bg"):
        cfg["model"][k]["radius"] = 0.5
    cfg["dataset"] = dict(data)
    dm = datasets.make("colmap", cfg["dataset"])
    tsys = systems.make(cfg["system"]["name"], cfg, dm,
                        save_dir=str(tmp_path / "torch"), device="cpu")
    tstate = tsys.load_checkpoint(path)
    for name in ("test", "predict"):
        want = jsys.render_image(jstate, jcolmap.ColmapSplit(dict(data),
                                                             name), 0)
        got = tsys.render_image(tstate, getattr(dm, name)(), 0)
        for k in ("comp_rgb_full", "opacity", "depth"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} {k}")
        assert got["ray_included"].all()
    assert np.isfinite(tsys.validate(tstate, n_images=1)["psnr"])
    assert np.isfinite(tsys.test(tstate, export=False)["psnr"])
    tsys.predict(tstate)
    save = str(tmp_path / "torch" / "it0-predict")
    assert sorted(os.listdir(save)) == ["0.png", "1.png", "2.png"]
    assert dm.train() is dm.train()  # read once
    assert torch.equal(torch.as_tensor(dm.val().all_images),
                       torch.as_tensor(dm.train().all_images))
