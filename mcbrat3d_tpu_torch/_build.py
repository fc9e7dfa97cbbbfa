"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each library is compiled from ``csrc/<name>.cu`` (with the shared headers
``csrc/*.cuh``) at first use, into ``build/torch_kernels/`` at the
repository root, under a name keyed by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused. ``build_all``
starts one nvcc per library at once. There is no fallback: a missing
``nvcc`` or a failed compile raises.
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


def _library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current
    sources (the .cu, every shared header) and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> dict:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one nvcc process each, all started together; returns name -> path."""
    libs = {name: _library_path(name) for name in names}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, libs[name])
        BUILD_INFO[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the
    path of the shared library."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
