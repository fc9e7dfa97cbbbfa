"""ctypes binding for the native scalar reference tracer.

PyTorch-port copy of ``mcbrat3d_tpu.tools.reference_tracer``, on the port's
``csrc/host/tracer.cpp`` (a copy of the JAX package's native/tracer.cpp),
built with g++ and OpenMP at first use (``_build.load_host``): an
independent Woodcock tracer whose statistics the transport kernels must
match (the validation-oracle role the reference's native integrator plays
for intercomparison). A failed build or load raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

_TRACE_FN = None


def _trace_native():
    global _TRACE_FN
    if _TRACE_FN is None:
        from mcbrat3d_tpu_torch import _build
        fn = _build.load_host("tracer").trace_photons
        fn.restype = None
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            f64, f64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_long, ctypes.c_uint64, f64, ctypes.c_void_p,
        ]
        _TRACE_FN = fn
    return _TRACE_FN


def trace(ext, ssa, dx, dy, dz, g, mu0, albedo, n_photons, seed=1,
          want_flux_up=False):
    """Run the scalar oracle on the [nx, ny, nz] extinction and
    single-scattering albedo fields. Returns a dict with the R, T, A
    fractions (+ flux_up [nx, ny] if requested). The photons are spread
    over the OpenMP threads, each with its own stream."""
    fn = _trace_native()
    ext = np.ascontiguousarray(ext, np.float64)
    ssa = np.ascontiguousarray(np.broadcast_to(ssa, ext.shape), np.float64)
    nx, ny, nz = ext.shape
    out = np.zeros(3)
    fu = np.zeros(nx * ny) if want_flux_up else None
    fn(nx, ny, nz, float(dx), float(dy), float(dz),
       ext.reshape(-1), ssa.reshape(-1),
       float(g), float(mu0), float(albedo),
       int(n_photons), int(seed), out,
       fu.ctypes.data if fu is not None else None)
    res = {"R": out[0] / n_photons, "T": out[1] / n_photons,
           "A": out[2] / n_photons}
    if want_flux_up:
        res["flux_up"] = fu.reshape(nx, ny)
    return res
