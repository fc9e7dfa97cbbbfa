"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each library is compiled from the sources under ``csrc/`` at first use, into
``build/torch_kernels/`` at the repository root, under a name keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. There is no fallback: a missing ``nvcc`` or a
failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LOADED: dict = {}
# name -> {"seconds": build time (0.0 when reused), "log": nvcc output}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "mcbrat3d_tpu_torch are built from csrc/ at first "
                       "use and need the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the
    path of the shared library."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    if lib.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO[name] = {"seconds": seconds, "log": proc.stdout + proc.stderr}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
