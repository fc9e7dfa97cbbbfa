"""Build and load the port's native libraries (compiler -> shared library
-> ctypes).

Each CUDA library is compiled from ``csrc/<name>.cu`` (with the shared
headers ``csrc/*.cuh``) at first use, into ``build/torch_kernels/`` at the
repository root, under a name keyed by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused. ``build_all``
starts one nvcc per library at once. The host libraries
(``csrc/host/<name>.cpp``: the alias-table builder, the Mie series, the
scalar reference tracer) are built the same way with g++ by
``load_host``, their hash also keyed by the CPU that ``-march=native``
targets. There is no fallback: a missing compiler or a failed compile
raises.
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

# g++ flags of each host library: those of the JAX package's loaders
# (sources/illumination.py, physics/mie.py, tools/reference_tracer.py), so
# the two builds of one source agree bit for bit on one machine
HOST_FLAGS = {
    "alias": ("-O3", "-march=native", "-shared", "-fPIC"),
    "mie": ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"),
    "tracer": ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"),
}

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


def _native_target() -> str:
    """The CPU that ``-march=native`` resolves to on this host, so a
    library built on another host is not reused here."""
    out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True).stdout
    return " ".join(line.split()[-1] for line in out.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def build_host(name: str) -> Path:
    """Compile ``csrc/host/<name>.cpp`` with g++ and ``HOST_FLAGS[name]``
    (if not already built for these sources, flags and CPU) and return the
    path of the shared library."""
    src = CSRC / "host" / f"{name}.cpp"
    flags = HOST_FLAGS[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(_native_target().encode())
    lib = BUILD_DIR / f"host-{name}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", *flags, str(src), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on host/{name}.cpp:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``csrc/host/<name>.cpp``, built at first
    use."""
    key = f"host/{name}"
    if key not in _LOADED:
        _LOADED[key] = ctypes.CDLL(str(build_host(name)))
    return _LOADED[key]
