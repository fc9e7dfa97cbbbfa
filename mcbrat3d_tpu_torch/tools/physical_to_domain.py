"""Physical particle properties (ASCII) -> domain converter.

PyTorch-port copy of ``mcbrat3d_tpu.tools.physical_to_domain``. Re-design
of the reference's PhysicalPropertiesToDomainNew tool (reference:
Tools/PhysicalPropertiesToDomainNew.f95): parses the four particle-file
formats, converts (mass content, effective radius) to optical properties
through Mie phase-function tables, optionally adds a molecular-absorption
profile and an analytic Rayleigh component, and writes a reference-schema
domain netCDF.

ASCII formats (reference: Tools/PhysicalPropertiesToDomainNew.f95:17-76):
  type 1: header + per-cell "ix iy iz LWC"; Reff derived from LWC and a
          fixed droplet number concentration
  type 2: per-cell "ix iy iz LWC Reff"
  type 3: per-cell "ix iy iz ncomp (type mass reff) x ncomp"
  type 4: header only (temperatures/heights, no particles)

Known reference deviation: the reference's rayleigh_extinct builds the
whole extinction profile from the *top-level* pressure because the
per-level pressures are not stored (reference:
Tools/PhysicalPropertiesToDomainNew.f95 rayleigh_extinct); here the
hypsometric integration keeps pressure per level, which is the evident
intent.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent
from mcbrat3d_tpu_torch.physics.phase_function import PhaseFunction, PhaseFunctionTable


@dataclasses.dataclass
class ParticleFile:
    file_type: int
    nx: int
    ny: int
    nz: int
    dx: float  # km
    dy: float  # km
    z_levels: np.ndarray  # [nz+1] km
    temps_levels: np.ndarray  # [nz+1] K
    # per-component [nx, ny, nz] fields; component c uses scattering table
    # table_index[c] (0-based)
    mass: List[np.ndarray] = dataclasses.field(default_factory=list)
    reff: List[np.ndarray] = dataclasses.field(default_factory=list)
    table_index: List[int] = dataclasses.field(default_factory=list)


def reff_from_lwc(lwc, drop_num_conc):
    """Type-1 files: Reff = 100 (LWC * 0.75 * 1.3889/(pi * N))^(1/3)
    (reference: Tools/PhysicalPropertiesToDomainNew.f95:31)."""
    return 100.0 * (np.maximum(lwc, 0.0) * 0.75 * 1.3889
                    / (np.pi * drop_num_conc)) ** (1.0 / 3.0)


def read_particle_file(path: str, drop_num_conc: float = 100.0) -> ParticleFile:
    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos:pos + n]
        if len(out) < n:
            raise ValueError(f"{path}: truncated file")
        pos += n
        return out

    ftype = int(take(1)[0])
    nx, ny, nz = (int(v) for v in take(3))
    dx, dy = (float(v) for v in take(2))
    z_levels = np.array([float(v) for v in take(nz + 1)])
    temps = np.array([float(v) for v in take(nz + 1)])
    pf = ParticleFile(ftype, nx, ny, nz, dx, dy, z_levels, temps)

    if ftype == 4:
        return pf

    if ftype in (1, 2):
        mass = np.zeros((nx, ny, nz))
        reff = np.zeros((nx, ny, nz))
        while pos < len(tokens):
            ix, iy, iz = (int(v) - 1 for v in take(3))
            lwc = float(take(1)[0])
            mass[ix, iy, iz] = lwc
            reff[ix, iy, iz] = (float(take(1)[0]) if ftype == 2
                                else reff_from_lwc(lwc, drop_num_conc))
        pf.mass = [mass]
        pf.reff = [reff]
        pf.table_index = [0]
        return pf

    if ftype == 3:
        fields = {}
        while pos < len(tokens):
            ix, iy, iz = (int(v) - 1 for v in take(3))
            ncomp = int(take(1)[0])
            for _ in range(ncomp):
                t = int(take(1)[0]) - 1
                m = float(take(1)[0])
                r = float(take(1)[0])
                if t not in fields:
                    fields[t] = (np.zeros((nx, ny, nz)), np.zeros((nx, ny, nz)))
                fields[t][0][ix, iy, iz] = m
                fields[t][1][ix, iy, iz] = r
        for t in sorted(fields):
            pf.mass.append(fields[t][0])
            pf.reff.append(fields[t][1])
            pf.table_index.append(t)
        return pf

    raise ValueError(f"{path}: unknown particle file type {ftype}")


def read_molecular_absorption(path: str):
    """(z_levels [nz+1] km, gas_ext [nz] km^-1)
    (reference: Tools/PhysicalPropertiesToDomainNew.f95:64-68)."""
    with open(path) as f:
        tokens = f.read().split()
    nz = int(tokens[0])
    z = np.array([float(v) for v in tokens[1:nz + 2]])
    ext = np.array([float(v) for v in tokens[nz + 2:2 * nz + 2]])
    return z, ext


def rayleigh_profile(z_levels, temps_levels, wavelen_um) -> np.ndarray:
    """Rayleigh extinction [km^-1] per layer from the temperature profile.

    Hypsometric pressure integration with per-level storage + exponential
    in-layer averaging (reference: rayleigh_extinct in
    Tools/PhysicalPropertiesToDomainNew.f95, with the per-level pressure
    fix noted in the module docstring)."""
    z = np.asarray(z_levels, np.float64)
    t = np.asarray(temps_levels, np.float64)
    nz = z.size - 1
    raylcoef = 2.97e-4 * wavelen_um ** (-4.15 + 0.2 * wavelen_um)

    pres = np.empty(nz + 1)
    lapse0 = 6.5e-3
    pres[0] = 1013.0 * (t[0] / (t[0] + lapse0 * z[0] * 1000.0)) ** (
        9.8 / (287.0 * lapse0))
    for i in range(nz):
        dz_m = 1000.0 * (z[i + 1] - z[i])
        lapse = (t[i] - t[i + 1]) / dz_m
        if abs(lapse) > 1e-4:
            pres[i + 1] = pres[i] * (t[i + 1] / t[i]) ** (9.8 / (287.0 * lapse))
        else:
            pres[i + 1] = pres[i] * np.exp(-9.8 * dz_m / (287.0 * t[i]))

    ext_lev = raylcoef * pres / t
    ratio = ext_lev[:-1] / ext_lev[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = np.where(np.abs(ratio - 1.0) > 1e-9,
                       (ext_lev[:-1] - ext_lev[1:]) / np.log(ratio),
                       0.5 * (ext_lev[:-1] + ext_lev[1:]))
    return avg


def rayleigh_phase_table_tool() -> PhaseFunctionTable:
    return PhaseFunctionTable([PhaseFunction.rayleigh()], key=[0.0],
                              description="Rayleigh (molecular)")


def particles_to_components(pf: ParticleFile,
                            scat_tables: Sequence[PhaseFunctionTable],
                            molec_abs: Optional[np.ndarray] = None,
                            rayleigh_wavelen: float = 0.0,
                            device="cuda"):
    """Convert the parsed particle file + Mie tables into OpticalComponents.

    (mass, Reff) -> extinction/SSA by linear interpolation in the table key,
    nearest-neighbor phase index (same math as the SSP path; reference:
    src/opticalProperties.f95:263-293).
    Returns (grid, components, cell_temps), the grid on ``device``.
    """
    nx, ny, nz = pf.nx, pf.ny, pf.nz
    grid = Grid.from_edges(pf.dx * np.arange(nx + 1),
                           pf.dy * np.arange(ny + 1), pf.z_levels,
                           device=device)
    components = []
    for mass, reff, ti in zip(pf.mass, pf.reff, pf.table_index):
        tbl = scat_tables[ti]
        key = np.asarray(tbl.key)
        ext_t = np.asarray(tbl.extinction)
        ssa_t = np.asarray(tbl.single_scattering_albedo)
        active = mass > 0
        bad = active & ((reff < key.min()) | (reff > key.max()))
        if np.any(bad):
            raise ValueError(f"effective radius outside table {ti + 1} range "
                             f"at {int(bad.sum())} cells")
        il = np.clip(np.searchsorted(key, reff) - 1, 0, key.size - 2)
        f = np.clip((reff - key[il]) / (key[il + 1] - key[il]), 0.0, 1.0)
        ext = np.where(active,
                       mass * ((1 - f) * ext_t[il] + f * ext_t[il + 1]), 0.0)
        ssa = np.where(active, (1 - f) * ssa_t[il] + f * ssa_t[il + 1], 0.0)
        pfi = np.where(active, np.where(f < 0.5, il, il + 1), 0).astype(np.int32)
        components.append(OpticalComponent(
            name=f"particle component {ti + 1}", extinction=ext,
            single_scattering_albedo=ssa, phase_function_index=pfi,
            phase_function_table=tbl))

    if molec_abs is not None:
        iso = PhaseFunctionTable([PhaseFunction.isotropic()], key=[0.0],
                                 description="Molecular Absorption")
        components.append(OpticalComponent(
            name="molecular absorption",
            extinction=np.asarray(molec_abs).reshape(1, 1, nz),
            single_scattering_albedo=np.zeros((1, 1, nz)),
            phase_function_index=np.zeros((1, 1, nz), np.int32),
            phase_function_table=iso))

    if rayleigh_wavelen > 0.0:
        rayl = rayleigh_profile(pf.z_levels, pf.temps_levels,
                                rayleigh_wavelen)
        components.append(OpticalComponent(
            name="Rayleigh scattering",
            extinction=rayl.reshape(1, 1, nz),
            single_scattering_albedo=np.ones((1, 1, nz)),
            phase_function_index=np.zeros((1, 1, nz), np.int32),
            phase_function_table=rayleigh_phase_table_tool()))

    cell_temps = np.broadcast_to(
        0.5 * (pf.temps_levels[:-1] + pf.temps_levels[1:]),
        (nx, ny, nz)).copy()
    return grid, components, cell_temps


def convert(particle_file: str, scat_table_files: Sequence[str],
            output_file: str, molec_abs_file: str = "",
            rayleigh_wavelen: float = 0.0, drop_num_conc: float = 100.0,
            surface_albedo: float = 0.0, lambda_um: float = 0.0) -> None:
    """Full tool flow: parse -> convert -> write domain netCDF (built on
    the host: the domain only goes to the file)."""
    from mcbrat3d_tpu_torch.domain.io_netcdf import (
        read_phase_function_table_file,
        write_domain,
    )
    pf = read_particle_file(particle_file, drop_num_conc)
    tables = [read_phase_function_table_file(p) for p in scat_table_files]
    molec = None
    if molec_abs_file:
        z_m, molec = read_molecular_absorption(molec_abs_file)
        if z_m.size != pf.z_levels.size or not np.allclose(z_m, pf.z_levels):
            raise ValueError("molecular-absorption z levels must match the "
                             "particle file levels")
    grid, components, temps = particles_to_components(
        pf, tables, molec_abs=molec, rayleigh_wavelen=rayleigh_wavelen,
        device="cpu")
    write_domain(output_file, grid, components, temps=temps,
                 lambda_um=lambda_um, surface_albedo=surface_albedo)
