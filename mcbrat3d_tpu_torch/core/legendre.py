"""Legendre polynomials and quadrature nodes.

Equivalent of the reference's numericUtilities quadrature kit
(reference: src/numericUtilities.f95:27-205 -- computeLobattoTerms,
computeGaussLegendreTerms, computeLegendrePolynomials). Node computation is
setup-time and runs in float64 NumPy (host code of the PyTorch port; the
transport kernel never evaluates Legendre series).
"""

from __future__ import annotations

import functools

import numpy as np


def legendre_eval_series(coeffs: np.ndarray, mu: np.ndarray) -> np.ndarray:
    """Evaluate P(mu) = sum_l (2l+1) c_l P_l(mu) with c_0 = 1 implied.

    ``coeffs`` holds c_1..c_L (the reference stores moments beyond the zeroth,
    which is always 1; reference: src/scatteringPhaseFunctions.f95:480-498).
    Upward recurrence: (l+1) P_{l+1} = (2l+1) mu P_l - l P_{l-1}.
    """
    mu = np.asarray(mu, np.float64)
    acc = np.ones_like(mu)  # (2*0+1) * c_0 * P_0 = 1
    p_prev = np.ones_like(mu)  # P_0
    p = mu.copy()  # P_1
    for l in range(1, len(coeffs) + 1):
        acc = acc + (2 * l + 1) * coeffs[l - 1] * p
        p_next = ((2 * l + 1) * mu * p - l * p_prev) / (l + 1)
        p_prev, p = p, p_next
    return acc


@functools.lru_cache(maxsize=256)
def _lobatto_cached(n: int):
    # Roots of P'_{n-1}: derivative coefficients via numpy's Legendre series.
    c = np.zeros(n)
    c[-1] = 1.0
    dc = np.polynomial.legendre.legder(c)
    interior = np.polynomial.legendre.legroots(dc)
    mus = np.concatenate(([-1.0], np.sort(interior), [1.0]))
    pn = np.polynomial.legendre.legval(mus, c)
    w = 2.0 / (n * (n - 1) * pn**2)
    mus.setflags(write=False)
    w.setflags(write=False)
    return mus, w


def lobatto(n: int):
    """Gauss-Lobatto nodes and weights on [-1, 1] (float64), n >= 2.

    Interior nodes are the roots of P'_{n-1}; endpoints are included
    (reference: src/numericUtilities.f95:27-115). Cached (read-only views):
    the root solve is an O(n^3) eigenvalue problem and broadband table
    setup requests the same orders for every (entry, wavelength).
    """
    if n < 2:
        raise ValueError("Lobatto quadrature needs n >= 2")
    return _lobatto_cached(n)


def legendre_moments_from_values(mus: np.ndarray, weights: np.ndarray,
                                 values: np.ndarray, n_moments: int) -> np.ndarray:
    """Project tabulated phase-function values onto Legendre moments c_1..c_L.

    c_l = (1/2) * integral P(mu) P_l(mu) dmu  (so that c_0 = 1 for a phase
    function normalized to integrate to 2 over mu; reference:
    src/scatteringPhaseFunctions.f95:652-750).
    Quadrature nodes/weights must resolve the product P * P_l.
    """
    out = np.empty(n_moments, np.float64)
    p_prev = np.ones_like(mus)
    p = mus.copy()
    for l in range(1, n_moments + 1):
        out[l - 1] = 0.5 * np.sum(weights * values * p)
        p_next = ((2 * l + 1) * mus * p - l * p_prev) / (l + 1)
        p_prev, p = p, p_next
    return out
