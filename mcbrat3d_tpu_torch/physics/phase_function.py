"""Scattering phase functions and tables.

Re-design of the reference's phase-function layer (reference:
src/scatteringPhaseFunctions.f95). A phase function is stored either as
Legendre moments c_1..c_L (c_0 == 1 implied) or as (angle, value) pairs;
tables are keyed by effective radius and carry per-entry extinction and
single-scattering albedo. All table construction is setup-time (float64
NumPy); the transport kernel consumes only the flattened device matrices
produced in :mod:`mcbrat3d_tpu_torch.physics.inverse_cdf`.

Normalization convention: integral over mu of P(mu) dmu = 2
(reference: src/scatteringPhaseFunctions.f95:1520-1536).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from mcbrat3d_tpu_torch.core.legendre import legendre_eval_series


@dataclasses.dataclass
class PhaseFunction:
    """One phase function: Legendre series or angle-value representation.

    Exactly one of (``coefficients``,) or (``angles``, ``values``) is set.
    ``angles`` are scattering angles in radians, increasing on [0, pi].
    """

    coefficients: Optional[np.ndarray] = None  # c_1..c_L, float64
    angles: Optional[np.ndarray] = None
    values: Optional[np.ndarray] = None
    extinction: float = 0.0
    single_scattering_albedo: float = 0.0
    description: str = ""
    # When the function is exactly Henyey-Greenstein, its asymmetry factor.
    # The transport kernel then samples the scattering angle analytically
    # (branch-free, no table gathers) instead of via the inverse-CDF table.
    hg_g: Optional[float] = None

    def __post_init__(self):
        has_lg = self.coefficients is not None
        has_av = self.angles is not None and self.values is not None
        if has_lg == has_av:
            raise ValueError("specify either Legendre coefficients or angle-value pairs")
        if has_lg:
            self.coefficients = np.asarray(self.coefficients, np.float64)
        else:
            self.angles = np.asarray(self.angles, np.float64)
            self.values = np.asarray(self.values, np.float64)
            if self.angles.shape != self.values.shape:
                raise ValueError("angles and values must have the same shape")
            if np.any(np.diff(self.angles) <= 0):
                raise ValueError("angles must be strictly increasing")

    # ------------------------------------------------------------------
    @property
    def is_legendre(self) -> bool:
        return self.coefficients is not None

    @property
    def n_moments(self) -> int:
        return 0 if self.coefficients is None else int(self.coefficients.size)

    def evaluate(self, angles_rad: np.ndarray) -> np.ndarray:
        """P(theta) at the given scattering angles (radians).

        Legendre storage evaluates the series; angle-value storage
        interpolates linearly in angle (reference:
        src/scatteringPhaseFunctions.f95:480-530).
        """
        ang = np.asarray(angles_rad, np.float64)
        if self.is_legendre:
            return legendre_eval_series(self.coefficients, np.cos(ang))
        return np.interp(ang, self.angles, self.values)

    # ------------------------------------------------------------------
    @staticmethod
    def henyey_greenstein(g: float, n_moments: int = 64,
                          description: str = "") -> "PhaseFunction":
        """Henyey-Greenstein via its exact Legendre expansion c_l = g^l
        (reference: Domain-Files/i3rcStepCloud.f95:64-66 builds HG tables the
        same way)."""
        l = np.arange(1, n_moments + 1, dtype=np.float64)
        return PhaseFunction(coefficients=g**l,
                             description=description or f"HG g={g}",
                             hg_g=float(g))


@dataclasses.dataclass
class PhaseFunctionTable:
    """A set of phase functions keyed by (effective radius or similar).

    Mirrors the reference's ``phaseFunctionTable``
    (reference: src/scatteringPhaseFunctions.f95:46-56) with per-entry
    extinction [km^-1 per unit content] and single-scattering albedo used by
    the SSP lookup path (reference: src/opticalProperties.f95:235-293).
    """

    phase_functions: Sequence[PhaseFunction]
    key: np.ndarray
    extinction: Optional[np.ndarray] = None
    single_scattering_albedo: Optional[np.ndarray] = None
    description: str = ""

    def __post_init__(self):
        self.key = np.asarray(self.key, np.float64)
        if len(self.phase_functions) != self.key.size:
            raise ValueError("key must have one entry per phase function")
        if self.extinction is not None:
            self.extinction = np.asarray(self.extinction, np.float64)
        if self.single_scattering_albedo is not None:
            self.single_scattering_albedo = np.asarray(
                self.single_scattering_albedo, np.float64)

    @property
    def n_entries(self) -> int:
        return len(self.phase_functions)
