"""Write the JPEG fixtures of this directory and ``manifest.json``.

Each fixture is a small image made from a seed with numpy and written
by Pillow (libjpeg-turbo) in one of the kinds ``rise_sdf_tpu_torch/
utils/jpeg.py`` reads: grey, 4:4:4, 4:2:2 and 4:2:0, restart
intervals, optimised Huffman tables, qualities 50 to 100, odd sizes,
an Adobe RGB file, a grey file with 2x2 sampling and 16-bit
quantisation tables (SOF1).  The manifest records, for each, the shape
and the SHA-256 of the bytes Pillow decodes (``np.asarray(Image.open(
p))``, C order), the witness of the decoder's output where Pillow is
not installed.

Run it where Pillow is installed: ``python tests/data/jpeg/
make_fixtures.py``.  It rewrites the files in place.
"""

import hashlib
import json
import os

import numpy as np
import PIL
from PIL import Image, features

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (height, width, mode, PIL save settings)
FIXTURES = {
    "grey_q90.jpg": (24, 40, "L", {"quality": 90}),
    "grey_2x2_37x53.jpg": (53, 37, "L", {"quality": 85,
                                         "subsampling": 2}),
    "444_q100.jpg": (32, 48, "RGB", {"quality": 100, "subsampling": 0}),
    "422_q75.jpg": (40, 56, "RGB", {"quality": 75, "subsampling": 1}),
    "420_q95.jpg": (48, 64, "RGB", {"quality": 95, "subsampling": 2}),
    "420_q50_optimized.jpg": (33, 47, "RGB", {"quality": 50,
                                              "subsampling": 2,
                                              "optimize": True}),
    "420_restart_blocks.jpg": (64, 80, "RGB", {
        "quality": 90, "subsampling": 2, "restart_marker_blocks": 3}),
    "422_restart_rows.jpg": (45, 70, "RGB", {
        "quality": 90, "subsampling": 1, "restart_marker_rows": 1}),
    "grey_restart_rows.jpg": (21, 30, "L", {
        "quality": 80, "restart_marker_rows": 2}),
    "420_1x1.jpg": (1, 1, "RGB", {"quality": 90, "subsampling": 2}),
    "420_7x5.jpg": (5, 7, "RGB", {"quality": 90, "subsampling": 2}),
    "422_37x53.jpg": (53, 37, "RGB", {"quality": 90, "subsampling": 1}),
    "420_129x67.jpg": (67, 129, "RGB", {"quality": 92, "subsampling": 2}),
    "adobe_rgb.jpg": (26, 35, "RGB", {"quality": 90, "keep_rgb": True}),
    "sof1_16bit_tables.jpg": (24, 32, "RGB", {
        "qtables": [[300 + 3 * i for i in range(64)],
                    [2 + i for i in range(64)]], "subsampling": 2}),
}


def pixels(h, w, c, seed):
    """A smooth pattern plus noise, uint8 [h, w, c]."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([np.sin(x / (4.0 + k) + k) * 70
                     + np.cos(y / (3.0 + k) + 2 * k) * 50 + 128
                     for k in range(c)], -1)
    return np.clip(base + rng.randn(h, w, c) * 20, 0, 255).astype(np.uint8)


def main():
    manifest = {"pillow": PIL.__version__,
                "libjpeg_turbo": features.version("libjpeg_turbo"),
                "files": {}}
    for seed, (name, (h, w, mode, kw)) in enumerate(sorted(
            FIXTURES.items())):
        c = 1 if mode == "L" else 3
        px = pixels(h, w, c, seed)
        path = os.path.join(HERE, name)
        Image.fromarray(px[..., 0] if c == 1 else px, mode).save(
            path, "JPEG", **kw)
        dec = np.ascontiguousarray(np.asarray(Image.open(path)))
        manifest["files"][name] = {
            "shape": [h, w, c],
            "sha256": hashlib.sha256(dec.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
