"""Landsat-class broken-cloud scene.

PyTorch-port counterpart of ``broken_cloud_scene`` in
``mcbrat3d_tpu.scenes.collection`` (pure NumPy, copied so the port stands
alone): a spatially correlated column-template field, beta = col_scale *
(iz < col_height), the shape of the reference's I3RC case-4 scene without
its proprietary data files (reference: Domain-Files/i3rcLandsatCloud.f95:
82-90). Such domains take the column-template kernel
(``transport.col_kernel``).
"""

from __future__ import annotations

import numpy as np

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalComponent
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)


def _hg_table(g: float, n_legendre: int, description: str = ""):
    return PhaseFunctionTable([PhaseFunction.henyey_greenstein(g, n_legendre)],
                              key=[1.0], description=description)


def broken_cloud_scene(nx: int = 128, ny: int = 128, nz: int = 64,
                       ssa: float = 0.99, g: float = 0.85,
                       dx: float = 30.0, dy: float = 30.0, dz: float = 20.0,
                       max_scale: float = 0.05, cloud_fraction: float = 0.45,
                       seed: int = 1, n_legendre: int = 64, device="cpu"):
    """(grid, components, temps) of the synthetic broken-cloud deck; feed
    to build_domain for transport or io_netcdf.write_domain for a
    reference-schema file."""
    rs = np.random.RandomState(seed)
    f = rs.rand(nx, ny)
    for _ in range(3):
        f = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0)
             + np.roll(f, 1, 1) + np.roll(f, -1, 1)) / 5.0
    cloudy = f > np.quantile(f, 1.0 - cloud_fraction)
    scale = rs.rand(nx, ny) * max_scale * cloudy
    h = np.ceil(f * nz).astype(int) * (scale > 0)
    scale = scale * (h > 0)
    ext = np.zeros((nx, ny, nz))
    for k in range(nz):
        ext[:, :, k] = np.where(k < h, scale, 0.0)
    grid = Grid.regular(nx=int(nx), ny=int(ny), nz=int(nz),
                        dx=dx, dy=dy, dz=dz, device=device)
    comp = OpticalComponent(
        name="broken cloud", extinction=ext,
        single_scattering_albedo=np.full_like(ext, ssa),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=_hg_table(g, n_legendre, "broken-cloud HG"))
    return grid, [comp], None
