"""Port parity: the saver's cubemap cross and image sequences.

``Saver.save_cubemap`` is pixel-equal to the JAX package's file (both
read back with cv2).  ``save_img_sequence`` writes a GIF
(``utils/gif.py``); imageio 2.37.4 with Pillow 12.1.0 reads it back
frame by frame equal to the port's own quantised frames
(``gif.quantize``) and to the port's decoder, with JAX's frame order
(the matcher's first group as an integer).  A frame of at most 256
colours is kept exactly; the test's frames of about 1,350 colours
(smooth RGB beside a jet colourmap) come back within 22 levels of 255
per channel, 3.0-3.8 on average (median cut to 256 colours), which the
test checks.  NeuS's ``test`` and
``predict`` write ``it{step}-test.gif`` and ``it{step}-predict.gif``,
one frame per view, as the JAX package names them.
"""

import os

import cv2
import imageio.v3 as iio
import numpy as np
import pytest

from rise_sdf_tpu.utils.saving import Saver as JSaver
from rise_sdf_tpu_torch import datasets, presets, systems
from rise_sdf_tpu_torch.utils import gif
from rise_sdf_tpu_torch.utils.png import read_png
from rise_sdf_tpu_torch.utils.saving import Saver

# levels of 255 on the test's frames of ~1,350 colours (measured: 22
# at most, 3.0-3.8 on average)
QUANT_MAX_ERR, QUANT_MEAN_ERR = 22, 4.0


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("channels,data_range", [(3, (0, 1)), (6, (-1, 2))])
def test_save_cubemap_equals_jax(tmp_path, channels, data_range):
    img = np.random.default_rng(channels).uniform(
        -1.2, 2.2, (6, 8, 8, channels)).astype(np.float32)
    want = JSaver(str(tmp_path / "jax")).save_cubemap("c/cube.png", img,
                                                      data_range=data_range)
    got = Saver(str(tmp_path / "port")).save_cubemap("c/cube.png", img,
                                                     data_range=data_range)
    assert got.endswith(os.path.join("c", "cube.png"))
    a, b = _cv2_rgb(got), _cv2_rgb(want)
    assert a.shape == (24, 32 * channels // 3, 3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(read_png(got), b)


def test_save_cubemap_cross_layout_on_the_port(tmp_path):
    """``tests/test_misc_tail.py``'s check on the port."""
    img = np.zeros((6, 8, 8, 3), np.float32)
    for i in range(6):
        img[i, :, :, 0] = (i + 1) / 6.0
    out = read_png(Saver(str(tmp_path)).save_cubemap("cube.png", img))
    assert out.shape == (24, 32, 3)
    np.testing.assert_allclose(out[12, 12, 0] / 255.0, 5 / 6.0, atol=0.01)
    assert out[0, 0].sum() == 0 and out[-1, -1].sum() == 0
    with pytest.raises(ValueError):
        Saver(str(tmp_path)).save_cubemap("bad.png", img[:5])


def _frame(i, h=30, w=44):
    """A smooth frame of many colours, different for each ``i``."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    f = np.stack([np.sin(0.1 * x + i), np.cos(0.13 * y - i),
                  np.sin(0.07 * (x + y) + 0.5 * i)], -1) * 0.5 + 0.5
    return f


def test_img_sequence_gif_reads_back_with_imageio(tmp_path):
    saver = Saver(str(tmp_path))
    for i in (0, 2, 10, 1):
        saver.save_image_grid(f"seq/{i}.png", [
            {"type": "rgb", "img": _frame(i)},
            {"type": "grayscale", "img": _frame(i)[..., 0]}])
    # frames the matcher skips, as JAX's does
    saver.save_image_grid("seq/3-pbr.png", [{"type": "rgb",
                                             "img": _frame(3)}])
    few = np.zeros((30, 88, 3), np.float32)
    few[:, :40] = [0.2, 0.4, 0.6]
    saver.save_image_grid("seq/11.png", [{"type": "rgb", "img": few}])
    path = saver.save_img_sequence("seq-video", "seq", r"(\d+)\.png")
    assert path == os.path.join(str(tmp_path), "seq-video.gif")
    order = [0, 1, 2, 10, 11]
    pngs = [read_png(os.path.join(str(tmp_path), "seq", f"{i}.png"))
            for i in order]
    frames = iio.imread(path, index=None)
    assert frames.shape == (len(order), 30, 88, 3)
    mine, delays = gif.read_gif(path)
    assert delays == [3] * len(order)  # round(100 / 30) hundredths
    assert iio.immeta(path)["loop"] == 0
    for png, pil, own in zip(pngs, frames, mine):
        idx, pal = gif.quantize(png)
        np.testing.assert_array_equal(pil, pal[idx])
        np.testing.assert_array_equal(own, pal[idx])
        err = np.abs(pil.astype(int) - png)
        assert err.max() <= QUANT_MAX_ERR and err.mean() <= QUANT_MEAN_ERR
    np.testing.assert_array_equal(frames[-1], pngs[-1])  # 2 colours: exact
    assert saver.save_img_sequence("none", "seq", r"(\d+)\.jpg") is None
    assert saver.save_img_sequence("none", "missing", r"(\d+)\.png") is None
    quiet = Saver(str(tmp_path / "rank1"), write=False)
    assert not os.path.exists(quiet.save_img_sequence("q", "seq",
                                                      r"(\d+)\.png"))


def test_gif_lzw_round_trips_long_and_random_frames(tmp_path):
    """A frame of random indices (the LZW table fills and clears many
    times) and a large flat one (codes at 12 bits) read back equal with
    imageio and the port's decoder."""
    rng = np.random.default_rng(0)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    pal = np.unique(pal, axis=0)
    noisy = pal[rng.integers(0, len(pal), (120, 150))]
    flat = np.zeros((400, 500, 3), np.uint8)
    flat[100:300, 50:60] = [255, 0, 0]
    path = str(tmp_path / "t.gif")
    gif.write_gif(path, [noisy, flat], fps=10)
    frames = iio.imread(path, index=None)
    mine, delays = gif.read_gif(path)
    assert delays == [10, 10]
    np.testing.assert_array_equal(frames[0][:120, :150], noisy)
    np.testing.assert_array_equal(mine[0], noisy)
    np.testing.assert_array_equal(frames[1], flat)
    np.testing.assert_array_equal(mine[1], flat)


def test_neus_test_and_predict_write_gifs(tmp_path):
    cfg = presets.tiny_neus_config()
    system = systems.make(cfg["system"]["name"], cfg,
                          datasets.make(cfg["dataset"]["name"],
                                        cfg["dataset"]),
                          save_dir=str(tmp_path), device="cpu")
    state = system.init_state(0)
    system.test(state, export=False)
    system.predict(state)
    n = len(system.datamodule.test())
    for name in ("it0-test", "it0-predict"):
        path = os.path.join(str(tmp_path), f"{name}.gif")
        frames = iio.imread(path, index=None)
        assert frames.shape[0] == n
        for i in range(n):
            png = read_png(os.path.join(str(tmp_path), name, f"{i}.png"))
            idx, pal = gif.quantize(png)
            np.testing.assert_array_equal(frames[i], pal[idx])
