"""Landsat-class broken-cloud, dense MODIS-class and broadband-LW flagship
scenes.

PyTorch-port counterparts of ``broken_cloud_scene``, ``dense_cloud_scene``,
``lw_flagship_scene``, ``lw_flagship_physical`` and
``write_lw_flagship_inputs`` in
``mcbrat3d_tpu.scenes.collection`` (pure NumPy, copied so the port stands
alone):

* the broken cloud, a spatially correlated column-template field,
  beta = col_scale * (iz < col_height), the shape of the reference's I3RC
  case-4 scene without its proprietary data files (reference:
  Domain-Files/i3rcLandsatCloud.f95:82-90), taken by the column-template
  kernel (``transport.col_kernel``);
* the dense cloud, a full-rank field (correlated amplitude x vertical ramp
  x per-cell noise), neither column-template nor separable: the
  BASELINE.md "MODIS-retrieved 3D domain" class, taken by the tiled
  dense-domain kernel (``transport.tile_kernel``);
* the 325 x 325 x 150 broadband-LW flagship, a rank-1 stratocumulus layer
  over a horizontally uniform gas absorber (separable:
  beta = a[col] * p[z] + q[z]), as optical components or as the
  physical-properties + SSP file pair of ``run/I3RC_bench_LW_325.nml``,
  taken by the separable-template kernel (``transport.sep_kernel``).
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
                       seed: int = 1, n_legendre: int = 64, device="cuda"):
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


def dense_cloud_scene(nx: int = 128, ny: int = 128, nz: int = 64,
                      ssa: float = 0.99, g: float = 0.85,
                      dx: float = 30.0, dy: float = 30.0,
                      dz: float = 20.0, max_scale: float = 0.04,
                      seed: int = 2, n_legendre: int = 64, device="cuda"):
    """(grid, components, temps) of the dense non-template broken cloud:
    correlated horizontal amplitude x adiabatic-like vertical ramp x
    per-cell noise, so the extinction field is full rank (the reference's
    replicated-domain model covers any such field,
    src/opticalProperties.f95:77-115)."""
    rs = np.random.RandomState(seed)
    f = rs.rand(nx, ny)
    for _ in range(3):
        f = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0)
             + np.roll(f, 1, 1) + np.roll(f, -1, 1)) / 5.0
    amp = (f > np.quantile(f, 0.5)) * f
    zc = (np.arange(nz) + 0.5) / nz
    prof = np.clip(1.5 * zc - 0.2, 0.0, 1.0) * (zc < 0.8)
    ext = max_scale * amp[:, :, None] * prof[None, None, :]
    ext *= (0.5 + rs.rand(nx, ny, nz))  # per-cell noise -> full rank
    grid = Grid.regular(nx=int(nx), ny=int(ny), nz=int(nz),
                        dx=dx, dy=dy, dz=dz, device=device)
    comp = OpticalComponent(
        name="dense cloud", extinction=ext,
        single_scattering_albedo=np.full_like(ext, ssa),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=_hg_table(g, n_legendre, "dense-cloud HG"))
    return grid, [comp], None


def lw_flagship_scene(nx: int = 325, ny: int = 325, nz: int = 150,
                      dx: float = 0.1, dy: float = 0.1, dz: float = 0.04,
                      cloud_base_level: int = 55, cloud_top_level: int = 85,
                      cloud_beta_max: float = 30.0, cloud_ssa: float = 0.6,
                      cloud_g: float = 0.85, gas_beta0: float = 0.6,
                      gas_scale_km: float = 2.0, cloud_fraction: float = 0.7,
                      t_surface: float = 288.0, lapse_km: float = 6.5,
                      seed: int = 7, n_legendre: int = 64, device="cuda"):
    """The I3RC broadband-LW benchmark shape: a 325 x 325 x 150 domain
    (reference: run/I3RC_bench_LW.deck:45 runs LWbench_325x325x150.nml at
    2000 ranks in <= 1 h). The reference's actual namelist/domain files are
    not in the repository, so this generator builds the same SHAPE with
    synthetic content: a spatially correlated stratocumulus layer
    (longwave single-scattering albedo ~0.6, HG g ~0.85), a horizontally
    uniform exponentially decaying gas absorber, and a lapse-rate
    temperature field for the Planck emission weighting.

    Returns (grid, components, temps)."""
    rs = np.random.RandomState(seed)
    grid = Grid.regular(nx=int(nx), ny=int(ny), nz=int(nz),
                        dx=dx, dy=dy, dz=dz, device=device)
    # correlated cloud mask + optical-depth texture
    f = rs.rand(nx, ny)
    for _ in range(4):
        f = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0)
             + np.roll(f, 1, 1) + np.roll(f, -1, 1)) / 5.0
    cloudy = f > np.quantile(f, 1.0 - cloud_fraction)
    amp = (f - f.min()) / max(f.max() - f.min(), 1e-9)
    n_cld = cloud_top_level - cloud_base_level
    # vertical profile: LWC-like ramp up through the layer
    zprof = np.linspace(0.3, 1.0, n_cld)
    ext_cld = np.zeros((nx, ny, n_cld), np.float64)
    ext_cld[:] = (cloud_beta_max * (amp * cloudy)[:, :, None]
                  * zprof[None, None, :])
    cloud = OpticalComponent(
        name="stratocumulus (LW)", extinction=ext_cld,
        single_scattering_albedo=np.full_like(ext_cld, cloud_ssa),
        phase_function_index=np.zeros(ext_cld.shape, np.int32),
        phase_function_table=_hg_table(cloud_g, n_legendre, "LW cloud HG"),
        z_level_base=int(cloud_base_level))
    # horizontally uniform gas absorber (water-vapor-continuum-like decay)
    z_km = (np.arange(nz) + 0.5) * dz
    beta_gas = gas_beta0 * np.exp(-z_km / gas_scale_km)
    gas = OpticalComponent(
        name="gas absorber", extinction=beta_gas.reshape(1, 1, nz),
        single_scattering_albedo=np.zeros((1, 1, nz)),
        phase_function_index=np.zeros((1, 1, nz), np.int32),
        phase_function_table=PhaseFunctionTable(
            [PhaseFunction.isotropic()], key=[1.0]))
    temps = (t_surface - lapse_km * z_km)[None, None, :] + np.zeros(
        (nx, ny, nz))
    return grid, [cloud, gas], temps


def lw_flagship_physical(nx: int = 325, ny: int = 325, nz: int = 150,
                         dx: float = 0.1, dy: float = 0.1, dz: float = 0.04,
                         cloud_base_level: int = 55,
                         cloud_top_level: int = 85,
                         n_lambda: int = 64,
                         lambda_lo_um: float = 8.0,
                         lambda_hi_um: float = 13.0,
                         cloud_fraction: float = 0.7,
                         t_surface: float = 288.0, lapse_km: float = 6.5,
                         surface_albedo: float = 0.05,
                         seed: int = 7, device="cuda"):
    """(CommonDomain, SSPTable) pair for the FILE-DRIVEN broadband-LW
    flagship deck (run/I3RC_bench_LW_325.nml): the physical-properties +
    single-scattering-property route the reference's I3RC_bench_LW.deck
    takes (physDomainFile + SSPfilename; reference:
    run/I3RC_bench_LW.deck:3-5,45, Drivers/monteCarloDriver.f95:889-1129).

    Same synthetic scene content as lw_flagship_scene, expressed
    physically so every wavelength bin is assembled by components_from_ssp:
      * cloud: rank-1 massConc (correlated horizontal amplitude x LWC
        ramp), constant Reff, volExt entries with per-lambda
        (extinction, ssa, HG-like Legendre rows);
      * gas: absXsec z-profile x pressure-derived number concentration
        (horizontally uniform pure absorber);
      * lapse-rate temperatures, z-uniform horizontally.
    Every per-bin domain is then SEPARABLE (beta = a[col]*p[z] + q[z]),
    so the broadband loop's compact rebuilds + the separable kernel carry
    the whole run (spectral/broadband.py).
    """
    from mcbrat3d_tpu_torch.domain.common import (CommonDomain, N_AVOGADRO,
                                            R_STAR)
    from mcbrat3d_tpu_torch.domain.ssp import SSPComponent, SSPTable

    C = 2.99792458e8
    rs = np.random.RandomState(seed)
    grid = Grid.regular(nx=int(nx), ny=int(ny), nz=int(nz),
                        dx=dx, dy=dy, dz=dz, device=device)
    lambdas = np.linspace(lambda_lo_um, lambda_hi_um, n_lambda)

    # cloud SSP entries: 3 Reff keys, mild spectral slopes, HG-g Legendre
    n_reff = 3
    starts = np.zeros((n_reff, n_lambda))
    lengths = np.zeros((n_reff, n_lambda))
    cmat = np.zeros((n_reff * 32, n_lambda))
    for li in range(n_lambda):
        pos = 1
        for e in range(n_reff):
            g1 = 0.80 + 0.02 * e + 0.1 * (lambdas[li] - lambda_lo_um) \
                / max(lambda_hi_um - lambda_lo_um, 1e-9) * 0.3
            l = np.arange(1, 33, dtype=np.float64)
            cmat[pos - 1:pos + 31, li] = g1 ** l
            starts[e, li] = pos
            lengths[e, li] = 32
            pos += 32
    # per-unit-mass extinction scaled so beta_max ~ 30 km^-1 at mass<=1
    ext = 30.0 * (1.0 + 0.05 * np.cos(
        np.linspace(0, np.pi, n_lambda)))[None, :] \
        * (0.9 + 0.1 * np.arange(n_reff))[:, None]
    ssa = np.clip(0.55 + 0.1 * np.linspace(0, 1, n_lambda)[None, :]
                  + 0.02 * np.arange(n_reff)[:, None], 0.0, 0.99)
    cloud = SSPComponent(
        name="stratocumulus (LW)", ext_type="volExt",
        key=np.array([5.0, 15.0, 25.0]),
        extinction=ext, ssa=ssa,
        legendre_start=starts, legendre_length=lengths,
        legendre_coeffs=cmat)

    # gas absXsec: water-vapor-continuum-like z decay + spectral texture;
    # beta_gas(z=0, mid-band) ~ 0.6 km^-1 with num_conc(0) = 1.2e25 m^-3
    z_km = (np.arange(nz) + 0.5) * dz
    xs0 = 0.6 / (1.2e25 * 1000.0)
    xsec = xs0 * (1.0 + 0.2 * np.sin(
        np.linspace(0, 3 * np.pi, n_lambda)))[None, :] \
        * np.ones((nz, 1))
    gas = SSPComponent(name="gas absorber", ext_type="absXsec", xsec=xsec)

    tbl = SSPTable(freq_hz=C * 1e6 / lambdas,
                   surface_albedo=np.full(n_lambda, surface_albedo),
                   components=[cloud, gas])

    # physical fields (mirroring lw_flagship_scene's structure)
    f = rs.rand(nx, ny)
    for _ in range(4):
        f = (f + np.roll(f, 1, 0) + np.roll(f, -1, 0)
             + np.roll(f, 1, 1) + np.roll(f, -1, 1)) / 5.0
    cloudy = f > np.quantile(f, 1.0 - cloud_fraction)
    amp = (f - f.min()) / max(f.max() - f.min(), 1e-9)
    zprof = np.zeros(nz)
    n_cld = cloud_top_level - cloud_base_level
    zprof[cloud_base_level:cloud_top_level] = np.linspace(0.3, 1.0, n_cld)
    mass = np.zeros((1, nx, ny, nz))
    mass[0] = (amp * cloudy)[:, :, None] * zprof[None, None, :]
    temps = np.broadcast_to(t_surface - lapse_km * z_km,
                            (nx, ny, nz)).copy()
    num0 = 1.2e25 * np.exp(-z_km / 2.0)  # m^-3, exponential scale height
    num_conc = np.broadcast_to(num0, (nx, ny, nz)).copy()
    # pressures consistent with num_conc through the ideal gas law (the
    # reader rebuilds num_conc from Pressures; reference:
    # src/opticalProperties.f95:413)
    pressure_hpa = num0 * R_STAR * temps[0, 0, :] / (N_AVOGADRO * 100.0)
    rho = np.broadcast_to(1.2 * np.exp(-z_km / 8.0), (nx, ny, nz)).copy()
    common = CommonDomain(grid=grid, temps=temps, num_conc=num_conc,
                          rho=rho, mass_conc=mass,
                          reff=np.full((1, nx, ny, nz), 10.0))
    return common, tbl, pressure_hpa


def write_lw_flagship_inputs(common_path: str = "common325.nc",
                             ssp_path: str = "ssp_thermal.nc", **kw):
    """Generate the flagship deck's input pair (see lw_flagship_physical):
    files the JAX package's readers read as they read its own."""
    from mcbrat3d_tpu_torch.domain.common import write_common
    from mcbrat3d_tpu_torch.domain.ssp import write_ssp_table

    # only written to the files: built on the host
    common, tbl, pressure_hpa = lw_flagship_physical(**{"device": "cpu",
                                                        **kw})
    write_common(common_path, common, pressure_hpa=pressure_hpa)
    write_ssp_table(ssp_path, tbl)
    return common_path, ssp_path
