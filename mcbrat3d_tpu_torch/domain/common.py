"""The lambda-independent physical domain ("commonDomain").

PyTorch-port counterpart of ``mcbrat3d_tpu.domain.common`` (host-side
NumPy and scipy netCDF; reference: src/opticalProperties.f95:63-75,
read_Common :347-451): grid edges, temperatures, pressure-derived molecular
number concentration (ideal gas), air density, and per-particle-component
mass concentration + effective radius. The SSP lookup (``domain.ssp``)
turns this + per-wavelength single-scattering-property tables into optical
components. The grid lives on the device given to ``read_common``; the
physical fields stay float64 NumPy on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.io import netcdf_file

from mcbrat3d_tpu_torch.core.grid import Grid

N_AVOGADRO = 6.02214076e23  # molecules / mol
R_STAR = 8.31446261815324  # J / (mol K)


@dataclasses.dataclass
class CommonDomain:
    grid: Grid
    temps: np.ndarray  # [nx, ny, nz] K
    num_conc: Optional[np.ndarray] = None  # [nx, ny, nz] molecules m^-3
    rho: Optional[np.ndarray] = None  # [nx, ny, nz] kg m^-3 (air density)
    mass_conc: Optional[np.ndarray] = None  # [ncomp, nx, ny, nz] g m^-3
    reff: Optional[np.ndarray] = None  # [ncomp, nx, ny, nz] microns

    @property
    def n_particle_components(self) -> int:
        return 0 if self.mass_conc is None else self.mass_conc.shape[0]


def num_conc_from_pressure(pressure_hpa, temps):
    """Ideal-gas molecular number concentration [m^-3] from pressure [hPa]
    (reference: src/opticalProperties.f95:413)."""
    p = np.asarray(pressure_hpa, np.float64)
    t = np.asarray(temps, np.float64)
    return p * 100.0 * N_AVOGADRO / (R_STAR * t)


def write_common(path: str, common: CommonDomain,
                 pressure_hpa=None) -> None:
    """Write a physical-properties file with the reader's schema
    (reference: read_Common, src/opticalProperties.f95:347-451: lowercase
    dims x-edges/..., vars Temperatures, Pressures, Density, massConc, Reff)."""
    g = common.grid
    xe, ye, ze = g.edges_np()
    nx, ny, nz = xe.size - 1, ye.size - 1, ze.size - 1

    with netcdf_file(path, "w") as nc:
        nc.createDimension("x-edges", xe.size)
        nc.createDimension("y-edges", ye.size)
        nc.createDimension("z-edges", ze.size)
        nc.createDimension("x-grid", nx)
        nc.createDimension("y-grid", ny)
        nc.createDimension("z-grid", nz)
        nc.createVariable("x-edges", "f8", ("x-edges",))[:] = xe
        nc.createVariable("y-edges", "f8", ("y-edges",))[:] = ye
        nc.createVariable("z-edges", "f8", ("z-edges",))[:] = ze
        nc.createVariable("Temperatures", "f8",
                          ("z-grid", "y-grid", "x-grid"))[:] = common.temps.T
        if pressure_hpa is not None:
            p = np.asarray(pressure_hpa, np.float64)
            if p.ndim == 1:
                nc.createVariable("Pressures", "f8", ("z-grid",))[:] = p
            else:
                nc.createVariable("Pressures", "f8",
                                  ("z-grid", "y-grid", "x-grid"))[:] = p.T
        if common.rho is not None:
            r = np.asarray(common.rho, np.float64)
            if np.allclose(r, r[0:1, 0:1, :]):
                nc.createVariable("Density", "f8", ("z-grid",))[:] = r[0, 0]
            else:
                nc.createVariable("Density", "f8",
                                  ("z-grid", "y-grid", "x-grid"))[:] = r.T
        if common.mass_conc is not None:
            ncomp = common.mass_conc.shape[0]
            nc.createDimension("nonGasComps", ncomp)
            # Fortran (comp, x, y, z) -> file (z, y, x, comp)
            nc.createVariable(
                "massConc", "f8",
                ("z-grid", "y-grid", "x-grid", "nonGasComps"))[:] = (
                common.mass_conc.T)
            nc.createVariable(
                "Reff", "f8",
                ("z-grid", "y-grid", "x-grid", "nonGasComps"))[:] = (
                common.reff.T)


def read_common(path: str, device="cuda") -> CommonDomain:
    """Read a physical-properties file (reference: read_Common); the grid
    is placed on ``device``."""
    with netcdf_file(path, "r", mmap=False) as nc:
        xe = np.array(nc.variables["x-edges"][:], np.float64)
        ye = np.array(nc.variables["y-edges"][:], np.float64)
        ze = np.array(nc.variables["z-edges"][:], np.float64)
        grid = Grid.from_edges(xe, ye, ze, device=device)
        nx, ny, nz = grid.shape
        temps = np.array(nc.variables["Temperatures"][:], np.float64).T

        num_conc = None
        if "Pressures" in nc.variables:
            p = np.array(nc.variables["Pressures"][:], np.float64)
            if p.ndim == 1:
                p = np.broadcast_to(p[None, None, :], (nx, ny, nz))
            else:
                p = p.T
            num_conc = num_conc_from_pressure(p, temps)

        rho = None
        if "Density" in nc.variables:
            r = np.array(nc.variables["Density"][:], np.float64)
            if r.ndim == 1:
                rho = np.broadcast_to(r[None, None, :], (nx, ny, nz)).copy()
            else:
                rho = r.T

        mass_conc = reff = None
        if "massConc" in nc.variables:
            mass_conc = np.array(nc.variables["massConc"][:], np.float64).T
            reff = np.array(nc.variables["Reff"][:], np.float64).T

        return CommonDomain(grid=grid, temps=temps, num_conc=num_conc,
                            rho=rho, mass_conc=mass_conc, reff=reff)
