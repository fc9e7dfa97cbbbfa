"""Planck emission and solar-spectrum helpers (setup-time, float64 NumPy).

Used by the emission-weighting layer (reference:
src/emissionAndBroadBandWeights.f95:424-550) and the Mie table generator's
spectral averaging (reference: Tools/MakeMieTable.f95:278-312).
"""

from __future__ import annotations

import numpy as np

# CODATA-ish constants (SI)
H_PLANCK = 6.62607015e-34  # J s
C_LIGHT = 2.99792458e8  # m / s
K_BOLTZ = 1.380649e-23  # J / K


def planck_radiance(lambda_um, temperature_k):
    """Spectral radiance B_lambda(T) in W m^-2 um^-1 sr^-1.

    ``lambda_um`` in microns. Vectorized over both arguments.
    """
    lam = np.asarray(lambda_um, np.float64) * 1e-6  # m
    t = np.asarray(temperature_k, np.float64)
    c1 = 2.0 * H_PLANCK * C_LIGHT**2
    c2 = H_PLANCK * C_LIGHT / K_BOLTZ
    with np.errstate(over="ignore"):
        b = c1 / (lam**5 * np.expm1(c2 / (lam * np.maximum(t, 1e-30))))
    return b * 1e-6  # per-m -> per-um


def planck_radiance_integrated(lambda_lo_um, lambda_hi_um, temperature_k, n_quad=32):
    """Band-integrated Planck radiance, W m^-2 sr^-1 (Gauss-Legendre in lambda)."""
    x, w = np.polynomial.legendre.leggauss(n_quad)
    lo = np.asarray(lambda_lo_um, np.float64)
    hi = np.asarray(lambda_hi_um, np.float64)
    half = 0.5 * (hi - lo)
    mid = 0.5 * (hi + lo)
    lam = mid[..., None] + half[..., None] * x  # [..., n_quad]
    vals = planck_radiance(lam, np.asarray(temperature_k, np.float64)[..., None])
    return np.sum(vals * w, axis=-1) * half
