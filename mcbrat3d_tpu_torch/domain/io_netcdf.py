"""Reference-compatible netCDF I/O (classic format via scipy).

PyTorch-port copy of ``mcbrat3d_tpu.domain.io_netcdf`` (host-side NumPy;
the same schema, so files move freely between the two packages).

Implements the reference's domain-file schema so MCBRaT3D domain files and
this framework's files interoperate:
  * write_Domain / read_Domain (reference: src/opticalProperties.f95:1087-1427)
  * phase-function table storage (reference:
    src/scatteringPhaseFunctions.f95:902-1118 add_PhaseFunctionTable) with
    both LegendreCoefficients and Angle-Value storage types -- including the
    reference's dimension-name typo "coefficents", kept verbatim for file
    compatibility.

Dimension-order note: netCDF-Fortran lists dimensions fastest-varying
first, so a Fortran var defined on (x, y, z) appears in the classic-file/C
view as (z, y, x); we transpose on both paths so in-memory arrays are
[nx, ny, nz] like the reference's Fortran arrays.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent
from mcbrat3d_tpu_torch.physics.phase_function import PhaseFunction, PhaseFunctionTable


def _prefix(i: int) -> str:
    """Component prefix (reference: opticalProperties.f95:1611-1621)."""
    return f"Component{i}_"


def _att(nc, name, default=None):
    v = getattr(nc, name, default)
    if isinstance(v, bytes):
        return v.decode()
    return v


# ---------------------------------------------------------------------------
# Phase-function tables
# ---------------------------------------------------------------------------

def add_phase_function_table(nc, table: PhaseFunctionTable, prefix: str = ""):
    """Write a table into an open netcdf_file (define-anytime in scipy)."""
    n = table.n_entries
    nc.createDimension(prefix + "phaseFunctionNumber", n)
    key = nc.createVariable(prefix + "phaseFunctionKeyT", "f4",
                            (prefix + "phaseFunctionNumber",))
    key[:] = np.asarray(table.key, np.float32)
    ext = nc.createVariable(prefix + "extinctionT", "f8",
                            (prefix + "phaseFunctionNumber",))
    ext[:] = (np.zeros(n) if table.extinction is None
              else np.asarray(table.extinction, np.float64))
    ssa = nc.createVariable(prefix + "singleScatteringAlbedoT", "f8",
                            (prefix + "phaseFunctionNumber",))
    ssa[:] = (np.zeros(n) if table.single_scattering_albedo is None
              else np.asarray(table.single_scattering_albedo, np.float64))
    if table.description:
        setattr(nc, prefix + "description", table.description)

    all_legendre = all(p.is_legendre for p in table.phase_functions)
    if all_legendre:
        lengths = np.array([max(p.n_moments, 1) for p in table.phase_functions],
                           np.int32)
        starts = np.concatenate(([1], 1 + np.cumsum(lengths)[:-1])).astype(np.int32)
        coeffs = np.zeros(int(lengths.sum()), np.float32)
        for i, p in enumerate(table.phase_functions):
            c = np.asarray(p.coefficients, np.float32)
            if c.size == 0:  # isotropic: single zero coefficient
                c = np.zeros(1, np.float32)
            coeffs[starts[i] - 1:starts[i] - 1 + lengths[i]] = c
        # NB: "coefficents" [sic] matches the reference writer
        nc.createDimension(prefix + "coefficents", int(lengths.sum()))
        nc.createVariable(prefix + "start", "i4",
                          (prefix + "phaseFunctionNumber",))[:] = starts
        nc.createVariable(prefix + "length", "i4",
                          (prefix + "phaseFunctionNumber",))[:] = lengths
        nc.createVariable(prefix + "legendreCoefficients", "f4",
                          (prefix + "coefficents",))[:] = coeffs
        setattr(nc, prefix + "phaseFunctionStorageType", "LegendreCoefficients")
    else:
        angles = table.phase_functions[0].angles
        if any(p.is_legendre or p.angles.shape != angles.shape
               or not np.allclose(p.angles, angles)
               for p in table.phase_functions):
            raise ValueError("angle-value tables must share one angle grid")
        nc.createDimension(prefix + "scatteringAngle", angles.size)
        nc.createVariable(prefix + "scatteringAngle", "f4",
                          (prefix + "scatteringAngle",))[:] = angles
        vals = nc.createVariable(
            prefix + "phaseFunctionValues", "f4",
            (prefix + "phaseFunctionNumber", prefix + "scatteringAngle"))
        vals[:] = np.stack([p.values for p in table.phase_functions]).astype(
            np.float32)
        setattr(nc, prefix + "phaseFunctionStorageType", "Angle-Value")


def read_phase_function_table(nc, prefix: str = "") -> PhaseFunctionTable:
    """Read a table written by this module or the reference
    (reference: read_PhaseFunctionTableOLD,
    src/scatteringPhaseFunctions.f95:1120-1277)."""
    key = np.array(nc.variables[prefix + "phaseFunctionKeyT"][:])
    n = key.size
    ext = np.array(nc.variables[prefix + "extinctionT"][:], np.float64)
    ssa = np.array(nc.variables[prefix + "singleScatteringAlbedoT"][:], np.float64)
    storage = _att(nc, prefix + "phaseFunctionStorageType", "")
    desc = _att(nc, prefix + "description", "") or ""

    pfs = []
    if storage == "LegendreCoefficients" or (
            prefix + "legendreCoefficients") in nc.variables:
        starts = np.array(nc.variables[prefix + "start"][:], np.int64)
        lengths = np.array(nc.variables[prefix + "length"][:], np.int64)
        coeffs = np.array(nc.variables[prefix + "legendreCoefficients"][:],
                          np.float64)
        for i in range(n):
            c = coeffs[starts[i] - 1:starts[i] - 1 + lengths[i]]
            pfs.append(PhaseFunction(coefficients=c,
                                     extinction=float(ext[i]),
                                     single_scattering_albedo=float(ssa[i])))
    else:
        angles = np.array(nc.variables[prefix + "scatteringAngle"][:], np.float64)
        vals = np.array(nc.variables[prefix + "phaseFunctionValues"][:], np.float64)
        for i in range(n):
            pfs.append(PhaseFunction(angles=angles, values=vals[i],
                                     extinction=float(ext[i]),
                                     single_scattering_albedo=float(ssa[i])))
    return PhaseFunctionTable(pfs, key=key, extinction=ext,
                              single_scattering_albedo=ssa, description=desc)


def write_phase_function_table(table: PhaseFunctionTable, path: str) -> None:
    """A phase-function table alone in a file (the Mie table tool's
    output, ``physprops``' input)."""
    with netcdf_file(path, "w") as nc:
        add_phase_function_table(nc, table)


def read_phase_function_table_file(path: str) -> PhaseFunctionTable:
    with netcdf_file(path, "r", mmap=False) as nc:
        return read_phase_function_table(nc)


# ---------------------------------------------------------------------------
# Domain files
# ---------------------------------------------------------------------------

def write_domain(path: str, grid: Grid, components, temps=None,
                 lambda_um: float = 0.0, lambda_index: int = 1,
                 n_lambda: int = 1, surface_albedo: float = 0.0) -> None:
    """Write a reference-schema domain file
    (reference: write_Domain, src/opticalProperties.f95:1087-1249)."""
    xe, ye, ze = grid.edges_np()
    nx, ny, nz = xe.size - 1, ye.size - 1, ze.size - 1

    with netcdf_file(path, "w") as nc:
        nc.createDimension("x-Edges", xe.size)
        nc.createDimension("y-Edges", ye.size)
        nc.createDimension("z-Edges", ze.size)
        nc.createDimension("x-Grid", nx)
        nc.createDimension("y-Grid", ny)
        nc.createDimension("z-Grid", nz)
        nc.createVariable("x-Edges", "f8", ("x-Edges",))[:] = xe
        nc.createVariable("y-Edges", "f8", ("y-Edges",))[:] = ye
        nc.createVariable("z-Edges", "f8", ("z-Edges",))[:] = ze
        t = nc.createVariable("Temperatures", "f8",
                              ("z-Grid", "y-Grid", "x-Grid"))
        tarr = (np.zeros((nx, ny, nz)) if temps is None
                else np.asarray(temps, np.float64))
        t[:] = tarr.T  # Fortran (x,y,z) -> file (z,y,x)

        nc.xyRegularlySpaced = np.int32(1 if grid.xy_regular else 0)
        nc.zRegularlySpaced = np.int32(1 if grid.z_regular else 0)
        setattr(nc, "lambda", np.float64(lambda_um))
        nc.lambdaIndex = np.int32(lambda_index)
        nc.numberOfLambdas = np.int32(n_lambda)
        nc.surfaceAlbedo = np.float64(surface_albedo)
        nc.numberOfComponents = np.int32(len(components))

        for i, comp in enumerate(components, start=1):
            p = _prefix(i)
            setattr(nc, p + "Name", comp.name)
            # Reference stores 1-based zLevelBase
            setattr(nc, p + "zLevelBase", np.int32(comp.z_level_base + 1))
            nzc = comp.extinction.shape[2]
            fills = comp.z_level_base == 0 and nzc == nz
            zdim = "z-Grid"
            if not fills:
                zdim = p + "z-Grid"
                nc.createDimension(zdim, nzc)
            if comp.is_horizontally_uniform:
                dims = (zdim,)
                e = comp.extinction[0, 0]
                a = comp.single_scattering_albedo[0, 0]
                pf = comp.phase_function_index[0, 0]
            else:
                dims = (zdim, "y-Grid", "x-Grid")
                e = comp.extinction.T
                a = comp.single_scattering_albedo.T
                pf = comp.phase_function_index.T
            nc.createVariable(p + "Extinction", "f8", dims)[:] = e
            nc.createVariable(p + "SingleScatteringAlbedo", "f8", dims)[:] = a
            # Reference stores 1-based phase indices as shorts
            nc.createVariable(p + "PhaseFunctionIndex", "h", dims)[:] = (
                pf.astype(np.int16) + 1)
            add_phase_function_table(nc, comp.phase_function_table, prefix=p)


def read_domain(path: str, device="cuda"):
    """Read a domain file -> (Grid, [OpticalComponent], temps, attrs dict).

    The grid's edge tensors are placed on ``device``.

    Accepts both this module's files and the reference's write_Domain output
    (reference: read_Domain, src/opticalProperties.f95:1251-1427).
    """
    with netcdf_file(path, "r", mmap=False) as nc:
        xe = np.array(nc.variables["x-Edges"][:], np.float64)
        ye = np.array(nc.variables["y-Edges"][:], np.float64)
        ze = np.array(nc.variables["z-Edges"][:], np.float64)
        grid = Grid.from_edges(xe, ye, ze, device=device)
        nz = ze.size - 1

        temps = None
        if "Temperatures" in nc.variables:
            temps = np.array(nc.variables["Temperatures"][:], np.float64).T

        n_comp = int(_att(nc, "numberOfComponents", 0) or 0)
        components = []
        for i in range(1, n_comp + 1):
            p = _prefix(i)
            name = _att(nc, p + "Name", f"component {i}") or f"component {i}"
            z_base = int(_att(nc, p + "zLevelBase", 1)) - 1
            ext = np.array(nc.variables[p + "Extinction"][:], np.float64)
            ssa = np.array(nc.variables[p + "SingleScatteringAlbedo"][:],
                           np.float64)
            pfi = np.array(nc.variables[p + "PhaseFunctionIndex"][:], np.int32)
            if ext.ndim == 1:  # horizontally uniform, stored [z]
                ext = ext[None, None, :]
                ssa = ssa[None, None, :]
                pfi = pfi[None, None, :]
            else:  # file (z,y,x) -> memory (x,y,z)
                ext = ext.T
                ssa = ssa.T
                pfi = pfi.T
            table = read_phase_function_table(nc, prefix=p)
            components.append(OpticalComponent(
                name=name, extinction=ext, single_scattering_albedo=ssa,
                phase_function_index=pfi - 1,  # file is 1-based
                phase_function_table=table, z_level_base=z_base))

        attrs = {
            "lambda_um": float(_att(nc, "lambda", 0.0) or 0.0),
            "lambda_index": int(_att(nc, "lambdaIndex", 1) or 1),
            "n_lambda": int(_att(nc, "numberOfLambdas", 1) or 1),
            "surface_albedo": float(_att(nc, "surfaceAlbedo", 0.0) or 0.0),
        }
        return grid, components, temps, attrs
