"""The I3RC, broadband, Landsat-class, MODIS-class and broadband-LW flagship
scenes.

PyTorch-port counterpart of ``mcbrat3d_tpu.scenes.collection`` (pure
NumPy, copied so the port stands alone). Each scene returns (grid,
components, temps) for build_domain or io_netcdf.write_domain, the grid on
``device`` (the card unless told otherwise). The reference's Domain-Files
programs (reference: Domain-Files/: stepcloud_2tau, homogBBDomain,
inhomogBBDomain, i3rcLandsatCloud, i3rcRadarCloud, MODISreToDomain, cubic,
write_HG) become ``step_cloud_2tau_scene``, ``homog_bb_scene``,
``inhomog_bb_scene``, ``landsat_cloud_scene`` and ``radar_cloud_scene``
(from their ASCII field files), ``modis_scene`` (LWC/Reff fields through a
Mie table), ``cubic_cloud_scene`` and ``hg_phase_values``. Besides them:

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


def step_cloud_2tau_scene(ssa: float = 1.0, tau_thin: float = 0.2,
                          tau_thick: float = 3.0, n_columns: int = 1000,
                          n_layers: int = 50, domain_size: float = 10000.0,
                          thickness: float = 500.0, g: float = 0.85,
                          n_legendre: int = 120, device="cuda"):
    """Semi-infinite two-tau step cloud (reference:
    Domain-Files/stepcloud_2tau.f95:36-49)."""
    grid = Grid.regular(nx=n_columns, ny=1, nz=n_layers,
                        dx=domain_size / n_columns, dy=domain_size,
                        dz=thickness / n_layers, device=device)
    ext = np.empty((n_columns, 1, n_layers))
    ext[: n_columns // 2] = tau_thin / thickness
    ext[n_columns // 2:] = tau_thick / thickness
    comp = OpticalComponent(
        name="step cloud 2tau", extinction=ext,
        single_scattering_albedo=np.full_like(ext, ssa),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=_hg_table(g, n_legendre))
    return grid, [comp], None


def cubic_cloud_scene(tau: float = 10.0, ssa: float = 1.0, g: float = 0.85,
                      nx: int = 32, ny: int = 32, nz: int = 32,
                      cube_fraction: float = 0.5,
                      domain_size: float = 1000.0,
                      thickness: float = 1000.0,
                      n_legendre: int = 64, device="cuda"):
    """Cubic cloud centered in an empty domain (reference:
    Domain-Files/cubic.f95)."""
    grid = Grid.regular(nx=nx, ny=ny, nz=nz, dx=domain_size / nx,
                        dy=domain_size / ny, dz=thickness / nz,
                        device=device)
    ext = np.zeros((nx, ny, nz))
    lo = [int(n * (1 - cube_fraction) / 2) for n in (nx, ny, nz)]
    hi = [int(n * (1 + cube_fraction) / 2) for n in (nx, ny, nz)]
    side_m = cube_fraction * thickness
    ext[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = tau / side_m
    comp = OpticalComponent(
        name="cubic cloud", extinction=ext,
        single_scattering_albedo=np.full_like(ext, ssa),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=_hg_table(g, n_legendre))
    return grid, [comp], None


def homog_bb_scene(beta_ext: float = 10.0, ssa: float = 0.99,
                   g: float = 0.85, iso_temp: float = 288.0,
                   nx: int = 10, ny: int = 10, nz: int = 10,
                   dx: float = 0.1, dy: float = 0.1, dz: float = 0.1,
                   hg_phase: bool = True, n_legendre: int = 64,
                   device="cuda"):
    """Broadband homogeneous isothermal domain (reference:
    Domain-Files/homogBBDomain.f95:33-60; stdin parameters become
    keyword arguments)."""
    grid = Grid.regular(nx=nx, ny=ny, nz=nz, dx=dx, dy=dy, dz=dz,
                        device=device)
    ext = np.full((nx, ny, nz), beta_ext)
    table = (_hg_table(g, n_legendre) if hg_phase
             else PhaseFunctionTable([PhaseFunction.isotropic()], key=[1.0]))
    comp = OpticalComponent(
        name="homogeneous medium", extinction=ext,
        single_scattering_albedo=np.full_like(ext, ssa),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=table)
    temps = np.full((nx, ny, nz), iso_temp)
    return grid, [comp], temps


def inhomog_bb_scene(pattern: str = "gaussian", beta_max: float = 30.0,
                     beta_min: float = 0.1, ssa: float = 0.99,
                     g: float = 0.85, surface_temp: float = 300.0,
                     lapse_rate_k_per_km: float = 6.5,
                     nx: int = 32, ny: int = 32, nz: int = 16,
                     dx: float = 0.1, dy: float = 0.1, dz: float = 0.1,
                     n_legendre: int = 64, device="cuda"):
    """Broadband inhomogeneous domain with shape-coded extinction fields
    (reference: Domain-Files/inhomogBBDomain.f95 builds analogous
    shape-parameterized fields). Patterns: gaussian | step | checker."""
    grid = Grid.regular(nx=nx, ny=ny, nz=nz, dx=dx, dy=dy, dz=dz,
                        device=device)
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    if pattern == "gaussian":
        r2 = (((i - nx / 2) / (nx / 4)) ** 2 + ((j - ny / 2) / (ny / 4)) ** 2
              + ((k - nz / 2) / (nz / 4)) ** 2)
        ext = beta_min + (beta_max - beta_min) * np.exp(-r2)
    elif pattern == "step":
        ext = np.where(i < nx // 2, beta_min, beta_max).astype(np.float64)
    elif pattern == "checker":
        ext = np.where((i // 4 + j // 4) % 2 == 0, beta_max, beta_min)
        ext = ext.astype(np.float64)
    else:
        raise ValueError(f"unknown pattern {pattern!r}")
    comp = OpticalComponent(
        name=f"inhomogeneous {pattern}", extinction=ext,
        single_scattering_albedo=np.full_like(ext, float(ssa)),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=_hg_table(g, n_legendre))
    ze = grid.edges_np()[2]
    z_mid = 0.5 * (ze[:-1] + ze[1:])
    temps = np.broadcast_to(
        surface_temp - lapse_rate_k_per_km * z_mid, (nx, ny, nz)).copy()
    return grid, [comp], temps


def _read_fixed_width_field(path: str, nx: int, ny: int) -> np.ndarray:
    """Read an [ny rows x nx columns] ASCII field (fixed-width f7.2 rows in
    the reference data files, but any whitespace/width-separated floats
    work). Returns [nx, ny]."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            vals = line.split()
            if len(vals) != nx:  # fixed-width without separators
                vals = [line[i * 7:(i + 1) * 7] for i in range(nx)]
            rows.append([float(v) for v in vals])
    arr = np.asarray(rows)
    if arr.shape != (ny, nx):
        raise ValueError(f"{path}: expected {ny}x{nx}, got {arr.shape}")
    return arr.T  # [nx, ny]


def landsat_cloud_scene(tau_file: str, dz_file: str, ssa: float = 1.0,
                        g: float = 0.85, nx: int = 128, ny: int = 128,
                        delta_xy: float = 30.0, delta_z: float = 20.0,
                        n_legendre: int = 299, device="cuda"):
    """I3RC case-4 Landsat scene from optical-depth and thickness fields
    (reference: Domain-Files/i3rcLandsatCloud.f95:27-90). Clouds fill the
    lowest ceil(thickness/deltaZ) layers of each column with extinction
    tau/thickness."""
    tau = _read_fixed_width_field(tau_file, nx, ny)
    thick = _read_fixed_width_field(dz_file, nx, ny) * 1000.0  # km -> m
    n_layers = int(np.ceil((thick.max() + delta_z / 2) / delta_z))
    grid = Grid.regular(nx=nx, ny=ny, nz=n_layers, dx=delta_xy, dy=delta_xy,
                        dz=delta_z, device=device)
    ext = np.zeros((nx, ny, n_layers))
    n_cells = np.minimum(np.ceil(thick / delta_z).astype(int), n_layers)
    # Spread tau over the discretized thickness so the column optical depth
    # is preserved exactly (the cloud is geometrically rounded up to whole
    # cells but optically exact).
    with np.errstate(divide="ignore", invalid="ignore"):
        beta = np.where(n_cells > 0,
                        tau / np.maximum(n_cells * delta_z, 1e-30), 0.0)
    for k in range(n_layers):
        ext[:, :, k] = np.where(k < n_cells, beta, 0.0)
    comp = OpticalComponent(
        name="Landsat cloud", extinction=ext,
        single_scattering_albedo=np.full_like(ext, ssa),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=_hg_table(g, n_legendre,
                                       "Henyey-Greenstein with g = 0.85"))
    return grid, [comp], None


def radar_cloud_scene(tau_file: str, ssa: float = 1.0, g: float = 0.85,
                      n_columns: int = 640, n_layers: int = 54,
                      delta_x: float = 50.0, delta_z: float = 45.0,
                      phase_table: PhaseFunctionTable | None = None,
                      n_legendre: int = 299, device="cuda"):
    """I3RC case-3 radar cloud: [n_columns x n_layers] extinction field
    (reference: Domain-Files/i3rcRadarCloud.f95:28-75; the C1 droplet phase
    function may be passed instead of Henyey-Greenstein)."""
    field = _read_fixed_width_field(tau_file, n_columns, n_layers)
    grid = Grid.regular(nx=n_columns, ny=1, nz=n_layers,
                        dx=delta_x, dy=n_columns * delta_x, dz=delta_z,
                        device=device)
    ext = field[:, None, :]
    comp = OpticalComponent(
        name="radar cloud", extinction=ext,
        single_scattering_albedo=np.full_like(ext, ssa),
        phase_function_index=np.zeros(ext.shape, np.int32),
        phase_function_table=phase_table or _hg_table(g, n_legendre))
    return grid, [comp], None


def modis_scene(lwc: np.ndarray, reff: np.ndarray,
                mie_table: PhaseFunctionTable,
                dx: float, dy: float, z_edges,
                temps: np.ndarray | None = None, device="cuda"):
    """MODIS-retrieved LWC/Reff fields -> domain component via a Mie table
    (reference: Domain-Files/MODISreToDomain.f95). LWC [g/m^3],
    Reff [um], table keyed by Reff with mass extinction [km^-1/(g m^-3)]."""
    lwc = np.atleast_3d(np.asarray(lwc, np.float64))
    reff = np.atleast_3d(np.asarray(reff, np.float64))
    nx, ny, nz = lwc.shape
    z_edges = np.asarray(z_edges, np.float64)
    grid = Grid.from_edges(dx * np.arange(nx + 1), dy * np.arange(ny + 1),
                           z_edges, device=device)
    key = np.asarray(mie_table.key)
    ext_t = np.asarray(mie_table.extinction)
    ssa_t = np.asarray(mie_table.single_scattering_albedo)
    active = lwc > 0
    il = np.clip(np.searchsorted(key, reff) - 1, 0, key.size - 2)
    f = np.clip((reff - key[il]) / (key[il + 1] - key[il]), 0.0, 1.0)
    ext = np.where(active, lwc * ((1 - f) * ext_t[il] + f * ext_t[il + 1]), 0)
    ssa = np.where(active, (1 - f) * ssa_t[il] + f * ssa_t[il + 1], 0.0)
    pfi = np.where(active, np.where(f < 0.5, il, il + 1), 0).astype(np.int32)
    comp = OpticalComponent(
        name="MODIS cloud", extinction=ext, single_scattering_albedo=ssa,
        phase_function_index=pfi, phase_function_table=mie_table)
    return grid, [comp], temps


def hg_phase_values(g: float = 0.85, n_angles: int = 181) -> np.ndarray:
    """[n_angles, 2] (angle_deg, value) dump of an HG phase function
    (reference: Domain-Files/write_HG.f95)."""
    ang = np.linspace(0.0, 180.0, n_angles)
    mu = np.cos(np.deg2rad(ang))
    vals = (1 - g**2) / (1 + g**2 - 2 * g * mu) ** 1.5
    return np.stack([ang, vals], axis=1)


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
