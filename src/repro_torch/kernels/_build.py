"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use with ``nvcc`` for ``sm_90a`` (Hopper) into ``kernels/build/``, a
directory that ``.gitignore`` lists, then loaded with :mod:`ctypes`. The
library's file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs at
import time: the CPU-only test suite imports every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)



class KernelError(RuntimeError):
    """A kernel of the port could not be built, loaded or launched on the card.

    No guardrail absorbs it: the solver dispatch and the online service
    re-raise it even when they run failsafe, so a failed kernel stops the
    run instead of handing the work to a CPU solver.
    """


#: libraries loaded in this process, by kernel source name.
_LOADED: Dict[str, ctypes.CDLL] = {}
#: the compiler's report (registers, spills) per built library path.
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source on first use")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns the library path. The compile writes to a temporary file in the
    build directory and renames it into place, so concurrent builders never
    load a half-written library.
    """
    src = os.path.join(SRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")
    if os.path.exists(lib):
        return lib
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise KernelError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOG[lib] = proc.stdout + proc.stderr
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build(name)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KernelError(f"cannot load {path}: {e}") from e
        _LOADED[name] = lib
    return lib
