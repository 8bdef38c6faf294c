"""Baseline JPEG reader (the port's counterpart of PIL's ``Image.open`` on
a JPEG in the JAX package's COLMAP loader).

``read_jpeg`` returns the bytes libjpeg-turbo gives PIL with its default
settings (``np.asarray(Image.open(p))``, but always with a channel
axis): uint8 [H, W, 1] for one component, [H, W, 3] RGB for three.  It
reads SOF0 and SOF1 files at 8-bit precision in one interleaved scan,
grey or three components at 4:4:4, 4:2:2 or 4:2:0, with or without
restart intervals, and decodes them as libjpeg-turbo does: the
``islow`` IDCT, fancy upsampling, the fixed-point YCbCr->RGB tables,
and libjpeg's rule for the colour space of a three-component file (a
JFIF marker means YCbCr, an Adobe marker decides by its transform flag,
component IDs R, G, B mean RGB, anything else YCbCr).  Progressive,
lossless, hierarchical and arithmetic-coded files, 12-bit precision,
four components, files of more than one scan and other samplings raise
``ValueError`` naming the file.  EXIF orientation is not applied (PIL's
``Image.open`` does not apply it either).

The decoder is ``csrc/jpeg_decode.cpp``, host C++ (entropy decoding is
serial), compiled with g++ at first use into ``_build/`` (keyed by a
hash of the source and the flags) and loaded with ``ctypes``.  A failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "jpeg_decode.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
SIGNATURE = b"\xff\xd8\xff"
_ERRLEN = 512

_lib: Optional[ctypes.CDLL] = None


def _so_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"jpeg_decode-{digest}.so"


def _compiler() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++ or c++) on PATH to build "
                           f"{SOURCE.name}")
    return cxx


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the decoder; raises with the
    compiler's output when the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed: "
                               f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn in (lib.jpeg_info, lib.jpeg_decode):
        fn.restype = ctypes.c_int
    lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                              ctypes.c_int]
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int]
    _lib = lib
    return lib


def decode_jpeg(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """The JPEG file ``buf`` as uint8 [H, W, C], C = 1 or 3; ``name``
    goes into the message of the ``ValueError`` it raises."""
    lib = load_library()
    err = ctypes.create_string_buffer(_ERRLEN)
    info = (ctypes.c_int * 3)()
    if lib.jpeg_info(buf, len(buf), info, err, _ERRLEN) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    h, w, c = info
    out = np.empty((h, w, c), np.uint8)
    if lib.jpeg_decode(buf, len(buf), out.ctypes.data, err, _ERRLEN) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """A baseline JPEG file as uint8 [H, W, C], C = 1 or 3."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"{path}: not a JPEG file")
    return decode_jpeg(buf, str(path))
