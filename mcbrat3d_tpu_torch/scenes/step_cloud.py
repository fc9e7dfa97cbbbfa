"""I3RC case-1 step cloud.

PyTorch-port counterpart of ``mcbrat3d_tpu.scenes.step_cloud`` (reference:
Domain-Files/i3rcStepCloud.f95:26-77): a 500 m wide domain of 32 columns,
250 m thick with 32 layers; the first 16 columns have optical depth 2, the
second 16 optical depth 18; Henyey-Greenstein phase function with g = 0.85;
single-scattering albedo 1.0 (non-absorbing) or 0.99 (absorbing).
"""

from __future__ import annotations

import numpy as np

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import (OpticalComponent, OpticalDomain,
                                              build_domain)
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)

_BUILD_KEYS = ("n_cdf_steps", "n_forward_angles", "compute_intensity_tables",
               "hybrid_width_deg", "macro_factor")


def step_cloud_scene(ssa: float = 1.0,
                     n_columns: int = 32,
                     n_layers: int = 32,
                     domain_size: float = 500.0,
                     thickness: float = 250.0,
                     g: float = 0.85,
                     n_legendre: int = 64,
                     tau_thin: float = 2.0,
                     tau_thick: float = 18.0,
                     device="cpu"):
    """(grid, components, temps) for the step cloud; feed to build_domain
    for transport or io_netcdf.write_domain for a reference-schema file."""
    grid = Grid.regular(nx=n_columns, ny=1, nz=n_layers,
                        dx=domain_size / n_columns, dy=domain_size,
                        dz=thickness / n_layers, device=device)
    ext = np.empty((n_columns, 1, n_layers), np.float64)
    ext[: n_columns // 2] = tau_thin / thickness
    ext[n_columns // 2:] = tau_thick / thickness

    table = PhaseFunctionTable(
        [PhaseFunction.henyey_greenstein(g, n_legendre)], key=[1.0],
        description="step cloud HG")
    comp = OpticalComponent(
        name="cloud" + (": non-absorbing" if ssa == 1.0 else ": absorbing"),
        extinction=ext,
        single_scattering_albedo=np.full_like(ext, ssa),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=table)
    return grid, [comp], None


def make_step_cloud(ssa: float = 1.0, **kwargs) -> OpticalDomain:
    build_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                    if k in _BUILD_KEYS}
    grid, components, temps = step_cloud_scene(ssa=ssa, **kwargs)
    return build_domain(grid, components, temps=temps, **build_kwargs)
