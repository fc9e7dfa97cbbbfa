"""Single-scattering-property (SSP) spectral tables (PyTorch port).

Copy of ``mcbrat3d_tpu.domain.ssp`` (host-side NumPy and scipy netCDF).

Re-design of the reference's broadband property pipeline: a multi-wavelength
table per component (built offline by the Mie tools) is combined with the
physical commonDomain (mass concentration, effective radius, number
concentration) into the per-wavelength OpticalDomain (reference:
read_SSPTable, src/opticalProperties.f95:147-345; table file written by
Tools/MieSSPTableCreate.f95:272-296).

Schema note (SURVEY.md section 7): the shipped reference *writer* and
*reader* disagree (SingleScatterAlbedoT vs SingleScatteringAlbedoT; missing
surfaceAlbedo). We follow the reader's names, which are the ones the solver
consumes, and always include surfaceAlbedo; the reader here also accepts the
writer-variant albedo name for tolerance.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
from scipy.io import netcdf_file

from mcbrat3d_tpu_torch.domain.common import CommonDomain
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)
from mcbrat3d_tpu_torch.physics.rayleigh import rayleigh_component

C_LIGHT = 2.99792458e8  # m/s


def lambda_um_from_freq(freq_hz):
    """f_grid stores frequency [Hz]; lambda[um] = c * 1e6 / f
    (reference: src/opticalProperties.f95:199)."""
    return C_LIGHT * 1e6 / np.asarray(freq_hz, np.float64)


@dataclasses.dataclass
class SSPComponent:
    """One component's spectral single-scattering properties.

    For particles (ext_type='volExt'): per (Reff-key, lambda) mass extinction
    [km^-1 / (g m^-3)], SSA, and Legendre phase-function coefficients.
    For gases (ext_type='absXsec'): absorption cross-section profile
    [m^2/molecule] per (z, lambda).
    """

    name: str
    ext_type: str  # 'volExt' | 'absXsec'
    z_level_base: int = 0  # 0-based
    # volExt fields
    key: Optional[np.ndarray] = None  # [nReff]
    extinction: Optional[np.ndarray] = None  # [nReff, nLambda]
    ssa: Optional[np.ndarray] = None  # [nReff, nLambda]
    # Legendre coefficients per (entry, lambda): list over lambda of
    # (starts [nReff], lengths [nReff], coeffs [total])
    legendre_start: Optional[np.ndarray] = None  # [nReff, nLambda], 1-based
    legendre_length: Optional[np.ndarray] = None  # [nReff, nLambda]
    legendre_coeffs: Optional[np.ndarray] = None  # [maxTotal, nLambda]
    # absXsec field
    xsec: Optional[np.ndarray] = None  # [nz, nLambda]
    description: str = ""


@dataclasses.dataclass
class SSPTable:
    freq_hz: np.ndarray  # [nLambda]
    surface_albedo: np.ndarray  # [nLambda]
    components: List[SSPComponent]

    @property
    def n_lambda(self) -> int:
        return self.freq_hz.size

    @property
    def lambdas_um(self) -> np.ndarray:
        return lambda_um_from_freq(self.freq_hz)


def write_ssp_table(path: str, table: SSPTable) -> None:
    """Write the reader-compatible SSP netCDF schema."""
    nl = table.n_lambda
    with netcdf_file(path, "w") as nc:
        nc.createDimension("f_grid_nelem", nl)
        nc.createVariable("f_grid", "f8", ("f_grid_nelem",))[:] = table.freq_hz
        nc.createVariable("surfaceAlbedo", "f8", ("f_grid_nelem",))[:] = (
            np.asarray(table.surface_albedo, np.float64))
        nc.numberOfComponents = np.int32(len(table.components))
        for i, c in enumerate(table.components, start=1):
            p = f"Component{i}_"
            setattr(nc, p + "Name", c.name)
            setattr(nc, p + "zLevelBase", np.int32(c.z_level_base + 1))
            setattr(nc, p + "extType", c.ext_type)
            if c.ext_type == "absXsec":
                zdim = p + "z-Grid"
                nc.createDimension(zdim, c.xsec.shape[0])
                nc.createVariable(p + "xsec", "f8",
                                  ("f_grid_nelem", zdim))[:] = c.xsec.T
            elif c.ext_type == "volExt":
                n = c.key.size
                nc.createDimension(p + "phaseFunctionNumber", n)
                nc.createVariable(p + "phaseFunctionKeyT", "f4",
                                  (p + "phaseFunctionNumber",))[:] = c.key
                nc.createVariable(
                    p + "ExtinctionT", "f8",
                    ("f_grid_nelem", p + "phaseFunctionNumber"))[:] = (
                    c.extinction.T)
                nc.createVariable(
                    p + "SingleScatteringAlbedoT", "f8",
                    ("f_grid_nelem", p + "phaseFunctionNumber"))[:] = c.ssa.T
                nc.createDimension(p + "maxCoefficients",
                                   c.legendre_coeffs.shape[0])
                nc.createVariable(
                    p + "start", "i4",
                    ("f_grid_nelem", p + "phaseFunctionNumber"))[:] = (
                    c.legendre_start.T.astype(np.int32))
                nc.createVariable(
                    p + "length", "i4",
                    ("f_grid_nelem", p + "phaseFunctionNumber"))[:] = (
                    c.legendre_length.T.astype(np.int32))
                nc.createVariable(
                    p + "legendreCoefficients", "f4",
                    ("f_grid_nelem", p + "maxCoefficients"))[:] = (
                    c.legendre_coeffs.T.astype(np.float32))
                setattr(nc, p + "phaseFunctionStorageType",
                        "LegendreCoefficients")
            else:
                raise ValueError(f"unknown extType {c.ext_type!r}")


def _att(nc, name, default=None):
    v = getattr(nc, name, default)
    return v.decode() if isinstance(v, bytes) else v


def read_ssp_table(path: str) -> SSPTable:
    with netcdf_file(path, "r", mmap=False) as nc:
        freq = np.array(nc.variables["f_grid"][:], np.float64)
        nl = freq.size
        if "surfaceAlbedo" in nc.variables:
            alb = np.array(nc.variables["surfaceAlbedo"][:], np.float64)
        else:
            alb = np.zeros(nl)
        n_comp = int(_att(nc, "numberOfComponents", 0) or 0)
        comps = []
        for i in range(1, n_comp + 1):
            p = f"Component{i}_"
            name = _att(nc, p + "Name", f"component {i}")
            ext_type = _att(nc, p + "extType", "volExt")
            z_base = int(_att(nc, p + "zLevelBase", 1)) - 1
            if ext_type == "absXsec":
                xsec = np.array(nc.variables[p + "xsec"][:], np.float64).T
                comps.append(SSPComponent(name=name, ext_type="absXsec",
                                          z_level_base=z_base, xsec=xsec))
                continue
            key = np.array(nc.variables[p + "phaseFunctionKeyT"][:], np.float64)
            ext = np.array(nc.variables[p + "ExtinctionT"][:], np.float64).T
            # tolerate both reader and writer albedo spellings (SURVEY 7)
            ssa_name = (p + "SingleScatteringAlbedoT"
                        if p + "SingleScatteringAlbedoT" in nc.variables
                        else p + "SingleScatterAlbedoT")
            ssa = np.array(nc.variables[ssa_name][:], np.float64).T
            starts = np.array(nc.variables[p + "start"][:], np.int64).T
            lengths = np.array(nc.variables[p + "length"][:], np.int64).T
            coeffs = np.array(nc.variables[p + "legendreCoefficients"][:],
                              np.float64).T
            comps.append(SSPComponent(
                name=name, ext_type="volExt", z_level_base=z_base,
                key=key, extinction=ext, ssa=ssa,
                legendre_start=starts, legendre_length=lengths,
                legendre_coeffs=coeffs))
        return SSPTable(freq_hz=freq, surface_albedo=alb, components=comps)


def particle_phase_table(c: SSPComponent, li: int) -> PhaseFunctionTable:
    """Per-wavelength PhaseFunctionTable for a volExt SSP component
    (the Legendre-row assembly of read_SSPTable; reference:
    src/opticalProperties.f95:267-311)."""
    ext_t = c.extinction[:, li]
    ssa_t = c.ssa[:, li]
    pfs = []
    for e in range(c.key.size):
        s = int(c.legendre_start[e, li]) - 1
        L = int(c.legendre_length[e, li])
        pfs.append(PhaseFunction(
            coefficients=c.legendre_coeffs[s:s + L, li],
            extinction=float(ext_t[e]),
            single_scattering_albedo=float(ssa_t[e])))
    return PhaseFunctionTable(
        pfs, key=c.key, extinction=ext_t,
        single_scattering_albedo=ssa_t, description=c.description)


def components_from_ssp(common: CommonDomain,
                        ssp_tables: Sequence[SSPTable],
                        lambda_index: int,
                        setup: bool = False,
                        calc_rayleigh: bool = True):
    """Assemble per-wavelength OpticalComponents from SSP tables + physics.

    Mirrors read_SSPTable's assembly (reference:
    src/opticalProperties.f95:181-345): gas components get xsec * numConc *
    1000 [km^-1]; particle components interpolate (extinction, SSA) linearly
    in effective radius and pick the nearest phase function; optional
    analytic Rayleigh component is appended. ``setup=True`` skips phase
    tables (dummy isotropic), used for the emission-CDF setup pass.

    Returns (components, surface_albedo, lambda_um).
    """
    nx, ny, nz = common.grid.shape
    components = []
    surface_albedo = 0.0
    lambda_um = 0.0
    particle_idx = 0  # index into common.mass_conc across ALL tables

    for ti, tbl in enumerate(ssp_tables):
        li = lambda_index
        # surfaceAlbedo/lambda come from the FIRST table only (the reference
        # creates new_Domain with them at n==1 in read_SSPTable; reference:
        # src/opticalProperties.f95:181-215); later tables' values are ignored
        if ti == 0:
            lambda_um = float(tbl.lambdas_um[li])
            surface_albedo = float(tbl.surface_albedo[li])
        for c in tbl.components:
            if c.ext_type == "absXsec":
                if common.num_conc is None:
                    raise ValueError(
                        "gas component needs pressures in the common domain")
                nzc = c.xsec.shape[0]
                zb = c.z_level_base
                # xsec [m^2/molecule] * numConc [m^-3] * 1000 -> km^-1,
                # over the FULL 3D number-concentration field sliced to the
                # component's z sub-range (reference:
                # src/opticalProperties.f95:217-234 applies numConc cell by
                # cell; a 3D-pressure domain must not collapse to column 0)
                num = common.num_conc[:, :, zb:zb + nzc]
                # keep the cheap horizontally-uniform path when all columns
                # are identical (1D-pressure domains)
                if np.all(num == num[0:1, 0:1, :]):
                    num = num[0:1, 0:1, :]
                ext = c.xsec[:, li][None, None, :] * num * 1000.0
                components.append(OpticalComponent(
                    name=c.name, extinction=ext,
                    single_scattering_albedo=np.zeros_like(ext),
                    phase_function_index=np.zeros(ext.shape, np.int32),
                    phase_function_table=PhaseFunctionTable(
                        [PhaseFunction.isotropic()], key=[0.0],
                        description="Molecular Absorption"),
                    z_level_base=c.z_level_base))
                continue

            # --- particle component (volExt) ---
            if common.mass_conc is None:
                raise ValueError(
                    "particle component needs massConc/Reff in common domain")
            mass = common.mass_conc[particle_idx]
            reff = common.reff[particle_idx]
            particle_idx += 1

            key = c.key
            ext_t = c.extinction[:, li]
            ssa_t = c.ssa[:, li]

            active = mass > 0.0
            bad = active & ((reff < key.min()) | (reff >= key.max()))
            if np.any(bad):
                raise ValueError(
                    f"component '{c.name}': effective radius outside table "
                    f"range at {int(bad.sum())} cells")
            il = np.clip(np.searchsorted(key, reff) - 1, 0, key.size - 2)
            f = (reff - key[il]) / (key[il + 1] - key[il])
            ext = np.where(active,
                           mass * ((1 - f) * ext_t[il] + f * ext_t[il + 1]),
                           0.0)
            ssa = np.where(active,
                           (1 - f) * ssa_t[il] + f * ssa_t[il + 1], 0.0)
            pfi = np.where(active,
                           np.where(f < 0.5, il, il + 1), 0).astype(np.int32)

            if setup:
                table = PhaseFunctionTable([PhaseFunction.isotropic()],
                                           key=[0.0], description="dummy")
                pfi = np.zeros_like(pfi)
            else:
                table = particle_phase_table(c, li)

            components.append(OpticalComponent(
                name=c.name, extinction=ext, single_scattering_albedo=ssa,
                phase_function_index=pfi, phase_function_table=table,
                z_level_base=c.z_level_base))

    if calc_rayleigh and not setup:
        if common.rho is None or common.num_conc is None:
            raise ValueError("Rayleigh needs Density and Pressures")
        components.append(rayleigh_component(
            lambda_um, common.rho[0, 0, :], common.num_conc[0, 0, :]))

    return components, surface_albedo, lambda_um
