"""Inverse-CDF tabulation of phase functions for scattering-angle sampling.

Re-implementation of the reference's inverse phase functions (reference:
src/inversePhaseFunctions.f95:66-174): trapezoidal CDF of P(mu) in mu,
followed by an exact within-bin inversion consistent with the trapezoid
rule.  The result is scattering angle as a function of cumulative
probability on ``n_steps`` uniform steps; the transport kernel samples it
with a single linear interpolation (two gathers) per scattering event.

Setup-time float64 NumPy; vectorized over table entries and CDF steps (the
reference loops; we solve every bin in one shot).
"""

from __future__ import annotations

import numpy as np

from mcbrat3d_tpu_torch.core.legendre import lobatto
from mcbrat3d_tpu_torch.physics.phase_function import PhaseFunction, PhaseFunctionTable


def inverse_cdf_single(pf: PhaseFunction, n_steps: int) -> np.ndarray:
    """Scattering angle [radians] at n_steps uniform CDF values in [0, 1]."""
    if pf.is_legendre:
        # Sample at Lobatto nodes of order >= nMoments
        # (reference: src/inversePhaseFunctions.f95:107-112), rounded UP to
        # the next power-of-two bucket (floor 64): the node count only sets
        # the CDF evaluation grid (more nodes = strictly finer), and the
        # O(n^3) root solve is cached per order -- bucketing collapses a
        # broadband table build from one eigensolve per (entry, lambda)
        # to at most ~8 total.
        n_ang = max(pf.n_moments, 64)
        n_ang = 1 << (n_ang - 1).bit_length()
        mus, _ = lobatto(n_ang)
        values = pf.evaluate(np.arccos(mus[::-1]))[::-1]  # increasing in mu
    else:
        mus = np.cos(pf.angles[::-1])
        values = pf.evaluate(pf.angles)[::-1]

    # Trapezoid CDF in mu, normalized to end exactly at 1
    # (reference: src/inversePhaseFunctions.f95:120-127).
    dmu = np.diff(mus)
    cdf = np.concatenate(([0.0], np.cumsum(dmu * 0.5 * (values[1:] + values[:-1]))))
    cdf /= cdf[-1]

    p = np.arange(n_steps, dtype=np.float64) / (n_steps - 1)
    idx = np.clip(np.searchsorted(cdf, p, side="right") - 1, 0, len(cdf) - 2)

    c0 = cdf[idx]
    c1 = cdf[idx + 1]
    v0 = values[idx]
    v1 = values[idx + 1]
    m0 = mus[idx]
    m1 = mus[idx + 1]

    dc = c1 - c0
    flat_cdf = dc <= np.spacing(np.maximum(c0, 1e-30))
    flat_val = np.abs(v0 - v1) <= np.spacing(np.maximum(np.abs(v0), 1e-30))

    # Generic analytic inversion of the trapezoid-rule CDF within the bin
    # (reference: src/inversePhaseFunctions.f95:148-166): solve the quadratic
    # for mu where the piecewise-linear P integrates to p.
    with np.errstate(divide="ignore", invalid="ignore"):
        lin = m0 + (m1 - m0) * (p - c0) / np.where(dc == 0, 1.0, dc)
        disc = ((c1 - p) * v0**2 + (p - c0) * v1**2) / np.where(dc == 0, 1.0, dc)
        gen = m0 + (m1 - m0) / (v0 - v1) * (v0 - np.sqrt(np.maximum(disc, 0.0)))

    mu_of_p = np.where(flat_cdf, m0, np.where(flat_val, lin, gen))
    out = np.arccos(np.clip(mu_of_p, -1.0, 1.0))
    out[-1] = 0.0  # CDF=1 -> forward direction (mu=+1), as in the reference
    return out


def inverse_cdf_table(table: PhaseFunctionTable, n_steps: int) -> np.ndarray:
    """[n_entries, n_steps] inverse-CDF matrix for a whole table
    (reference: src/inversePhaseFunctions.f95:26-64)."""
    return np.stack([inverse_cdf_single(p, n_steps) for p in table.phase_functions])
