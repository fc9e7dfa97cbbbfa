"""Rayleigh (molecular-scattering) transmission spectrum tool.

PyTorch-port copy of ``mcbrat3d_tpu.tools.molec_scatt_trans``. Equivalent
of the reference's RayleighTrans program (reference:
Tools/molecScattTrans.f95:1-55): read a common (physical) domain, derive
the molecular number-concentration profile from pressure and temperature
(ideal gas), and for each wavelength on a grid compute the column-0
Rayleigh extinction profile and the vertical beam transmission trans =
exp(-sum(dz * ext)). Output: one text row per wavelength with (lambda [um],
gas absorption x-section, surface-layer extinction [km^-1], surface-layer
SSA, transmission) -- the same five columns the reference writes to
RayleighTrans.txt.

The reference hard-codes its input path and a 1000-step 0.201-1.2 um
wavelength grid; here both are parameters.
"""

from __future__ import annotations

import numpy as np

from mcbrat3d_tpu_torch.domain.common import CommonDomain, read_common
from mcbrat3d_tpu_torch.physics.rayleigh import rayleigh_extinction


def rayleigh_transmission(common: CommonDomain, lambdas_um) -> np.ndarray:
    """[nLambda, 5] rows of (lambda, absx, ext_sfc, ssa_sfc, transmission).

    Uses the column (0, 0) profile like the reference
    (Tools/molecScattTrans.f95:36-46); extinction is km^-1 and layer depths
    come from the z-edge spacing. Rayleigh SSA is identically 1 and the
    tool passes zero gas absorption (absx = 0), matching the reference.
    """
    ze = common.grid.edges_np()[2]
    depths_km = np.diff(ze) / 1000.0  # grid stores meters
    if common.num_conc is None:
        raise ValueError("common domain has no pressure/number "
                         "concentration; cannot compute Rayleigh profile")
    n_prof = np.asarray(common.num_conc[0, 0, :], np.float64)
    # the reference scales by (rho/rho0)^2; without a density field the
    # standard-atmosphere proxy is rho ~ n * m_air (exact ratio cancels in
    # calc_RayleighScattering's rho^2/N form when rho is ideal-gas-derived)
    if common.rho is not None:
        rho_prof = np.asarray(common.rho[0, 0, :], np.float64)
    else:
        m_air = 28.9647e-3 / 6.02214129e23  # kg per molecule
        rho_prof = n_prof * m_air

    out = np.empty((len(lambdas_um), 5), np.float64)
    for i, lam in enumerate(np.asarray(lambdas_um, np.float64)):
        ext = rayleigh_extinction(float(lam), rho_prof, n_prof)  # km^-1
        trans = float(np.exp(-np.sum(depths_km * ext)))
        out[i] = (lam, 0.0, float(ext[0]), 1.0, trans)
    return out


def main(common_path: str, output_path: str = "RayleighTrans.txt",
         lambda_start_um: float = 0.201, lambda_stop_um: float = 1.2,
         n_lambda: int = 1000) -> int:
    common = read_common(common_path, device="cpu")
    lambdas = np.linspace(lambda_start_um, lambda_stop_um, n_lambda)
    rows = rayleigh_transmission(common, lambdas)
    with open(output_path, "w") as f:
        for row in rows:
            f.write("".join(f"{v:20.16f}" for v in row) + "\n")
    return 0
