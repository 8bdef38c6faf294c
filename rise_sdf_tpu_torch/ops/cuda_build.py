"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled
into ``_build/<name>-<hash>.so`` (the hash covers the source and the
flags, so an edited source rebuilds), then loaded with ``ctypes``.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output per built source (ptxas register / spill report)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _so_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_libraries(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built
    yet, one ``nvcc`` process per source, all running at once; raises
    with nvcc's output when a build fails."""
    jobs = []
    for name in names:
        so = _so_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, cmd, proc, tmp, so))
    failed = []
    for name, cmd, proc, tmp, so in jobs:
        build_logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"building {name}.cu failed: {' '.join(cmd)}"
                          f"\n{build_logs[name]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``csrc/<name>.cu``; raises with
    nvcc's output when the build fails."""
    if name in _LIBS:
        return _LIBS[name]
    build_libraries([name])
    lib = ctypes.CDLL(str(_so_path(name)))
    _LIBS[name] = lib
    return lib
