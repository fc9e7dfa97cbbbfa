"""Analytic Rayleigh (molecular) scattering component.

Copy of ``mcbrat3d_tpu.physics.rayleigh`` for the PyTorch port (host-side
NumPy; reference: calc_RayleighScattering, src/opticalProperties.f95:
2052-2086): depolarization-corrected lambda^-4 volume extinction from air
density and number concentration, SSA = 1, and the Rayleigh phase function
as Legendre moments.
"""

from __future__ import annotations

import numpy as np

from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)

_F_DEPOL = 1.060816681  # depolarization ("King") correction factor
_RHO0 = 1.275  # reference air density [kg m^-3]


def rayleigh_extinction(lambda_um: float, rho, num_conc):
    """Volume extinction [km^-1] for air density ``rho`` [kg m^-3] and
    molecular number concentration ``num_conc`` [m^-3]
    (reference: src/opticalProperties.f95:2075-2076)."""
    lam = float(lambda_um)
    mr1 = (6.4328e-5 + 2.94981e-2 / (146.0 - lam**-2)
           + 2.554e-4 / (41.0 - lam**-2))
    rho = np.asarray(rho, np.float64)
    n = np.asarray(num_conc, np.float64)
    return (32.0e27 * _F_DEPOL * np.pi**3 * rho**2 * mr1**2
            / (3.0 * n * _RHO0**2 * lam**4))


def rayleigh_phase_table() -> PhaseFunctionTable:
    """Rayleigh phase function table (Legendre (0, 0.5) scaled by 1/(2l+1);
    reference: src/opticalProperties.f95:2080-2082)."""
    return PhaseFunctionTable([PhaseFunction.rayleigh()], key=[0.0],
                              description="Rayleigh Scattering")


def rayleigh_component(lambda_um: float, rho_profile, num_conc_profile):
    """Horizontally uniform Rayleigh OpticalComponent for a z-profile."""
    from mcbrat3d_tpu_torch.domain.domain import OpticalComponent
    ext = rayleigh_extinction(lambda_um, rho_profile, num_conc_profile)
    nz = ext.size
    return OpticalComponent(
        name="Rayleigh Scattering",
        extinction=ext.reshape(1, 1, nz),
        single_scattering_albedo=np.ones((1, 1, nz)),
        phase_function_index=np.zeros((1, 1, nz), np.int32),
        phase_function_table=rayleigh_phase_table(),
        z_level_base=0)
