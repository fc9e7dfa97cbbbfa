"""Mie scattering: the native C++ series through ctypes, and its NumPy
plain version.

PyTorch-port copy of ``mcbrat3d_tpu.physics.mie``. The native kernel
(``csrc/host/mie.cpp``, a copy of the JAX package's native/mie.cpp) plays
the role of the reference's F77 solver (reference: Tools/mieindsub.f)
inside the offline table-generation pipeline; it is compiled at first use
with g++ into ``build/torch_kernels/`` and loaded through ctypes. The
vectorized NumPy implementation of the same algorithm is its plain version,
which the tests hold it against.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np

_MIE_FN = None


def _series_terms(x: float) -> int:
    if x <= 8.0:
        n = x + 4.0 * x ** (1 / 3) + 1.0
    elif x < 4200.0:
        n = x + 4.05 * x ** (1 / 3) + 2.0
    else:
        n = x + 4.0 * x ** (1 / 3) + 2.0
    return int(n) + 2


def mie_numpy(x: float, m: complex, mu: np.ndarray):
    """Single-sphere Mie: returns (qext, qsca, intensity[mu]).

    intensity = (|S1|^2 + |S2|^2)/2 at the given scattering cosines.
    """
    x = float(x)
    nmax = _series_terms(x)
    mx = m * x
    nstart = nmax + 15 + int(abs(mx) * 0.02)

    d = np.zeros(nstart + 1, complex)
    for n in range(nstart, 0, -1):
        an = n / mx
        d[n - 1] = an - 1.0 / (d[n] + an)

    psi = np.zeros(nmax + 1)
    chi = np.zeros(nmax + 1)
    psi_m1, psi[0] = np.cos(x), np.sin(x)
    chi_m1, chi[0] = -np.sin(x), np.cos(x)
    for n in range(1, nmax + 1):
        f = (2 * n - 1) / x
        psi[n] = f * psi[n - 1] - psi_m1
        chi[n] = f * chi[n - 1] - chi_m1
        psi_m1, chi_m1 = psi[n - 1], chi[n - 1]

    n_arr = np.arange(1, nmax + 1)
    xi = psi[1:] - 1j * chi[1:]
    xi_m1 = psi[:-1] - 1j * chi[:-1]
    da = d[1:nmax + 1] / m + n_arr / x
    db = d[1:nmax + 1] * m + n_arr / x
    a = (da * psi[1:] - psi[:-1]) / (da * xi - xi_m1)
    b = (db * psi[1:] - psi[:-1]) / (db * xi - xi_m1)

    w = 2 * n_arr + 1
    qext = 2.0 / x**2 * np.sum(w * (a.real + b.real))
    qsca = 2.0 / x**2 * np.sum(w * (np.abs(a) ** 2 + np.abs(b) ** 2))

    mu = np.asarray(mu, np.float64)
    nq = mu.size
    pi_nm1 = np.zeros(nq)
    pi_n = np.ones(nq)
    s1 = np.zeros(nq, complex)
    s2 = np.zeros(nq, complex)
    for n in range(1, nmax + 1):
        tau_n = n * mu * pi_n - (n + 1) * pi_nm1
        f = (2 * n + 1) / (n * (n + 1))
        s1 += f * (a[n - 1] * pi_n + b[n - 1] * tau_n)
        s2 += f * (a[n - 1] * tau_n + b[n - 1] * pi_n)
        pi_np1 = ((2 * n + 1) * mu * pi_n - (n + 1) * pi_nm1) / n
        pi_nm1, pi_n = pi_n, pi_np1
    intensity = 0.5 * (np.abs(s1) ** 2 + np.abs(s2) ** 2)
    return qext, qsca, intensity


def _mie_native():
    """``mie_batch`` of ``csrc/host/mie.cpp`` through ctypes, built with
    g++ at first use (``_build.load_host``, the JAX package's flags); a
    failed build or load raises."""
    global _MIE_FN
    if _MIE_FN is None:
        from mcbrat3d_tpu_torch import _build
        fn = _build.load_host("mie").mie_batch
        fn.restype = ctypes.c_int
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        fn.argtypes = [ctypes.c_int, f64, ctypes.c_double, ctypes.c_double,
                       ctypes.c_int, f64, f64, f64, f64]
        _MIE_FN = fn
    return _MIE_FN


def mie_batch(x_values, m: complex, mu, force_numpy: bool = False):
    """Batch Mie over size parameters: (qext [n], qsca [n],
    intensity [n, nquad]) from the native kernel, or with ``force_numpy``
    from ``mie_numpy``, its plain version. Where the native series refuses
    a size (x <= 0; it returns that index) the batch is computed by
    ``mie_numpy``, with a warning, as the JAX package does."""
    x = np.ascontiguousarray(x_values, np.float64)
    mu = np.ascontiguousarray(mu, np.float64)
    n, nq = x.size, mu.size
    qext = np.empty(n)
    qsca = np.empty(n)
    inten = np.empty((n, nq))
    if not force_numpy:
        rc = _mie_native()(n, x, float(m.real), float(abs(m.imag)), nq, mu,
                           qext, qsca, inten)
        if rc == 0:
            return qext, qsca, inten
        warnings.warn(f"native mie_batch failed at size index {rc - 1}; "
                      "computing the batch with mie_numpy")
    for i in range(n):
        qext[i], qsca[i], inten[i] = mie_numpy(x[i],
                                               complex(m.real, abs(m.imag)),
                                               mu)
    return qext, qsca, inten
