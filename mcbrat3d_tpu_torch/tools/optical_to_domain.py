"""SHDOM-style ASCII optical properties -> domain converter.

PyTorch-port copy of ``mcbrat3d_tpu.tools.optical_to_domain``. Re-design of
the reference's OpticalPropertiesToDomain tool (reference:
Tools/OpticalPropertiesToDomain.f95): a tabulated-phase-function ASCII file
(header 'T' line; Nx Ny Nz; delX delY Z(1..Nz+1); numphase; one Legendre
series per phase function with SHDOM normalization Chi_l = (2l+1) c_l; then
one line per cell: ix iy iz Temp Extinct Albedo Iphase) becomes a
reference-schema domain netCDF.
"""

from __future__ import annotations

import numpy as np

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent
from mcbrat3d_tpu_torch.physics.phase_function import PhaseFunction, PhaseFunctionTable


def read_shdom_optical_file(path: str, device="cuda"):
    """Parse the SHDOM-like file -> (grid, component, temps), the grid on
    ``device``."""
    with open(path) as f:
        tokens = f.read().split()
    pos = 0

    def take(n=1):
        nonlocal pos
        out = tokens[pos:pos + n]
        if len(out) < n:
            raise ValueError(f"{path}: truncated optical-properties file")
        pos += n
        return out

    flag = take(1)[0]
    if not flag.upper().startswith("T"):
        raise ValueError(f"{path}: first token must be 'T' (tabulated), "
                         f"got {flag!r}")
    nx, ny, nz = (int(v) for v in take(3))
    dx, dy = (float(v) for v in take(2))
    z_levels = np.array([float(v) for v in take(nz + 1)])
    numphase = int(take(1)[0])

    phase_functions = []
    for _ in range(numphase):
        num_l = int(take(1)[0])
        chi = np.array([float(v) for v in take(num_l)])
        # SHDOM stores Chi_l = (2l+1) c_l; convert to the framework's c_l
        # (reference converts the same way;
        # Tools/OpticalPropertiesToDomain.f95:41-46)
        l = np.arange(1, num_l + 1)
        phase_functions.append(PhaseFunction(coefficients=chi / (2 * l + 1)))
    table = PhaseFunctionTable(phase_functions,
                               key=np.arange(1, numphase + 1, dtype=float),
                               description="SHDOM tabulated phase functions")

    ext = np.zeros((nx, ny, nz))
    ssa = np.zeros((nx, ny, nz))
    pfi = np.zeros((nx, ny, nz), np.int32)
    temps = np.zeros((nx, ny, nz))
    while pos < len(tokens):
        ix, iy, iz = (int(v) - 1 for v in take(3))
        t, e, a = (float(v) for v in take(3))
        ip = int(take(1)[0]) - 1
        temps[ix, iy, iz] = t
        ext[ix, iy, iz] = e
        ssa[ix, iy, iz] = a
        pfi[ix, iy, iz] = ip

    grid = Grid.from_edges(dx * np.arange(nx + 1), dy * np.arange(ny + 1),
                           z_levels, device=device)
    comp = OpticalComponent(
        name="tabulated optical properties", extinction=ext,
        single_scattering_albedo=ssa, phase_function_index=pfi,
        phase_function_table=table)
    return grid, comp, temps


def convert(input_file: str, output_file: str,
            surface_albedo: float = 0.0, lambda_um: float = 0.0) -> None:
    from mcbrat3d_tpu_torch.domain.io_netcdf import write_domain
    grid, comp, temps = read_shdom_optical_file(input_file, device="cpu")
    write_domain(output_file, grid, [comp], temps=temps,
                 lambda_um=lambda_um, surface_albedo=surface_albedo)
