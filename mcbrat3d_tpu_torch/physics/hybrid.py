"""Hybrid (Gaussian-forward-peak) phase functions for local estimation.

Pure-NumPy copy of ``mcbrat3d_tpu.physics.hybrid`` (setup-time host code),
so the port builds bit-identical forward tables without importing JAX.

Variance-reduction transform used when computing radiances: the strongly
peaked forward lobe of the tabulated phase function is replaced by a
width-matched Gaussian that joins the original continuously, then the
Gaussian part is renormalized so the whole function still integrates to 2
over mu (reference: src/opticalProperties.f95:1936-2050,
computeHybridPhaseFunctions / phaseFuncDiff / computeNormalization; the
idea is Evans' variance reduction for local estimation).
"""

from __future__ import annotations

import numpy as np


def _gaussian_normalization(mus, values, gaussian, k):
    """P0 such that P0*gaussian[:k+1] + values[k+1:] integrates to 2 over mu.

    ``mus`` decrease with angle index (mu = cos(theta), theta increasing).
    """
    int_gaus = np.sum(0.5 * (gaussian[:k] + gaussian[1 : k + 1])
                      * (mus[:k] - mus[1 : k + 1]))
    n = len(mus)
    int_orig = np.sum(0.5 * (values[k : n - 1] + values[k + 1 : n])
                      * (mus[k : n - 1] - mus[k + 1 : n]))
    if int_orig >= 2.0:
        return 1.0 / int_gaus
    return (2.0 - int_orig) / int_gaus


def hybrid_phase_values(angles: np.ndarray, values: np.ndarray,
                        gaussian_width_deg: float) -> np.ndarray:
    """Hybridize forward-tabulated phase functions.

    ``angles``: [n_angles] radians, uniform on [0, pi].
    ``values``: [n_entries, n_angles].
    Returns the hybridized [n_entries, n_angles] matrix.
    """
    values = np.asarray(values, np.float64)
    if values.ndim == 1:
        values = values[None, :]
    n_angles = angles.size
    mus = np.cos(angles)
    width_rad = gaussian_width_deg * np.pi / 180.0
    gaussian = np.exp(-((angles / width_rad) ** 2))

    out = values.copy()
    lower0 = int(np.searchsorted(angles, width_rad)) + 1
    if lower0 >= n_angles - 2:
        return out

    for i in range(values.shape[0]):
        # Find the transition angle where the normalized Gaussian equals the
        # original phase function: bracket by hunting then bisect
        # (reference: src/opticalProperties.f95:1962-2003).
        def diff(k):
            p0 = _gaussian_normalization(mus, values[i], gaussian, k)
            return p0 * gaussian[k] - values[i][k]

        lo = lower0
        d_lo = diff(lo)
        inc = 1
        found = False
        while True:
            hi = min(lo + inc, n_angles - 2)
            d_hi = diff(hi)
            if lo >= n_angles - 2:
                break
            if d_lo * d_hi < 0:
                found = True
                break
            if hi >= n_angles - 2:
                break
            lo, d_lo = hi, d_hi
            inc *= 2
        if not found:
            continue  # no root: keep the original phase function

        while hi > lo + 1:
            mid = (lo + hi) // 2
            d_mid = diff(mid)
            if d_mid * d_hi < 0:
                lo, d_lo = mid, d_mid
            else:
                hi, d_hi = mid, d_mid

        k = lo
        p0 = _gaussian_normalization(mus, values[i], gaussian, k)
        out[i, : k + 1] = p0 * gaussian[: k + 1]
    return out
