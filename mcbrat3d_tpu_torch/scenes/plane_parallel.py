"""Homogeneous plane-parallel slab scenes for validation.

PyTorch-port counterpart of ``mcbrat3d_tpu.scenes.plane_parallel``
(reference: Domain-Files/planeParallel.f95; Drivers/planeParallel.f95:6-16
-- the 'bare-bones' validation case whose fluxes and radiances can be
checked against analytic results).
"""

from __future__ import annotations

import numpy as np

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import (OpticalComponent, OpticalDomain,
                                              build_domain)
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)


def plane_parallel_scene(tau: float = 1.0,
                         ssa: float = 1.0,
                         phase: PhaseFunction | None = None,
                         g: float | None = None,
                         nx: int = 4, ny: int = 4, nz: int = 8,
                         domain_size_km: float = 1.0,
                         thickness_km: float = 1.0,
                         device="cuda"):
    """(grid, components, temps) for a uniform slab of optical depth tau."""
    if phase is None:
        phase = (PhaseFunction.henyey_greenstein(g) if g
                 else PhaseFunction.isotropic())
    grid = Grid.regular(nx=nx, ny=ny, nz=nz,
                        dx=domain_size_km / nx, dy=domain_size_km / ny,
                        dz=thickness_km / nz, device=device)
    ext = np.full((nx, ny, nz), tau / thickness_km, np.float64)
    table = PhaseFunctionTable([phase], key=[1.0])
    comp = OpticalComponent(
        name="slab",
        extinction=ext,
        single_scattering_albedo=np.full_like(ext, ssa),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=table)
    return grid, [comp], None


def make_slab(tau: float = 1.0,
              ssa: float = 1.0,
              phase: PhaseFunction | None = None,
              nx: int = 4, ny: int = 4, nz: int = 8,
              domain_size_km: float = 1.0,
              thickness_km: float = 1.0,
              device="cuda",
              **build_kwargs) -> OpticalDomain:
    """Uniform slab of optical depth ``tau`` with the given phase function
    (isotropic by default), on ``device``."""
    grid, components, temps = plane_parallel_scene(
        tau=tau, ssa=ssa, phase=phase, nx=nx, ny=ny, nz=nz,
        domain_size_km=domain_size_km, thickness_km=thickness_km,
        device=device)
    return build_domain(grid, components, temps=temps, **build_kwargs)
