"""Result writers: ASCII files with provenance headers, mirroring the
reference's output structure (flux, absorption profile, 3D absorption,
radiance, the fluxes by scattering order; reference:
Drivers/monteCarloDriver.f95:1324-1495 writeResults_ASCII), in the JAX
driver's format. Every value carries its standard error. The netCDF
writer lives in domain/io_netcdf.py-adjacent module results_netcdf().
"""

from __future__ import annotations

from mcbrat3d_tpu_torch.driver.run import Results


def _header(results: Results, extra: str = "") -> str:
    cfg = results.config
    lines = [
        "! MCBRaT3D-TPU results",
        f"! totalPhotons = {results.total_photons}",
        f"! numBatches = {results.n_batches}",
        f"! solarFlux = {results.solar_flux!r}",
    ]
    if cfg is not None:
        lines += [
            f"! solarMu = {cfg.solar_mu}  solarAzimuth = {cfg.solar_azimuth}",
            f"! useRayTracing = {cfg.use_ray_tracing}  "
            f"useRussianRoulette = {cfg.use_russian_roulette}",
            f"! iseed = {cfg.iseed}",
        ]
    if extra:
        lines.append("! " + extra)
    return "\n".join(lines) + "\n"


def write_flux_file(path: str, results: Results, grid) -> None:
    """Domain means + pixel-level boundary fluxes with standard errors."""
    m, s = results.mean, results.stderr
    with open(path, "w") as f:
        f.write(_header(results))
        f.write("! mean fluxes: up, stderr, down, stderr, absorbed, stderr\n")
        f.write("%.8e %.8e %.8e %.8e %.8e %.8e\n" % (
            m["mean_flux_up"], s["mean_flux_up"],
            m["mean_flux_down"], s["mean_flux_down"],
            m["mean_flux_absorbed"], s["mean_flux_absorbed"]))
        f.write("! ix iy fluxUp stderr fluxDown stderr fluxAbsorbed stderr\n")
        up, dn, ab = m["flux_up"], m["flux_down"], m["flux_absorbed"]
        eu, ed, ea = s["flux_up"], s["flux_down"], s["flux_absorbed"]
        nx, ny = up.shape
        for j in range(ny):
            for i in range(nx):
                f.write(f"{i + 1:5d} {j + 1:5d} "
                        f"{up[i, j]:.8e} {eu[i, j]:.8e} "
                        f"{dn[i, j]:.8e} {ed[i, j]:.8e} "
                        f"{ab[i, j]:.8e} {ea[i, j]:.8e}\n")


def write_absorption_profile_file(path: str, results: Results, grid) -> None:
    """Horizontally averaged absorption profile (W m^-3 per incident flux)."""
    z = grid.edges_np()[2]
    prof = results.mean["absorption_profile"]
    err = results.stderr["absorption_profile"]
    with open(path, "w") as f:
        f.write(_header(results))
        f.write("! zBottom zTop absorption stderr\n")
        for k in range(prof.size):
            f.write(f"{z[k]:.6e} {z[k + 1]:.6e} {prof[k]:.8e} {err[k]:.8e}\n")


def write_volume_absorption_file(path: str, results: Results, grid) -> None:
    vol = results.mean["volume_absorption"]
    err = results.stderr["volume_absorption"]
    nx, ny, nz = vol.shape
    with open(path, "w") as f:
        f.write(_header(results))
        f.write("! ix iy iz absorption stderr\n")
        for k in range(nz):
            for j in range(ny):
                for i in range(nx):
                    f.write(f"{i + 1:5d} {j + 1:5d} {k + 1:5d} "
                            f"{vol[i, j, k]:.8e} {err[i, j, k]:.8e}\n")


def write_radiance_file(path: str, results: Results, grid) -> None:
    cfg = results.config
    mus, phis = cfg.radiance_directions()
    rad = results.mean["intensity"]
    err = results.stderr["intensity"]
    nx, ny, nd = rad.shape
    with open(path, "w") as f:
        f.write(_header(results, extra=f"numRadianceDirections = {nd}"))
        f.write("! idir mu phi then rows: ix iy radiance stderr\n")
        for d in range(nd):
            f.write(f"# direction {d + 1}: mu = {mus[d]:.6f} "
                    f"phi = {phis[d]:.2f}\n")
            for j in range(ny):
                for i in range(nx):
                    f.write(f"{i + 1:5d} {j + 1:5d} "
                            f"{rad[i, j, d]:.8e} {err[i, j, d]:.8e}\n")


def write_aux_flux_by_order(path: str, results: Results, grid) -> None:
    """Per-scattering-order boundary fluxes (the reference's auxhist01
    output; reference: Drivers/monteCarloDriver.f95:95-101)."""
    up = results.mean["flux_up_by_order"]
    dn = results.mean["flux_down_by_order"]
    eu = results.stderr["flux_up_by_order"]
    ed = results.stderr["flux_down_by_order"]
    nx, ny, nk = up.shape
    with open(path, "w") as f:
        f.write(_header(results, extra=f"numScatteringOrders = {nk - 1} "
                                       "(last bin = overflow)"))
        f.write("! order ix iy fluxUp stderr fluxDown stderr\n")
        for k in range(nk):
            for j in range(ny):
                for i in range(nx):
                    f.write(f"{k:4d} {i + 1:5d} {j + 1:5d} "
                            f"{up[i, j, k]:.8e} {eu[i, j, k]:.8e} "
                            f"{dn[i, j, k]:.8e} {ed[i, j, k]:.8e}\n")


def write_all(results: Results, grid) -> list:
    """Write every output the config names; return the paths written."""
    cfg = results.config
    written = []
    if cfg.auxhist01_flux_file and "flux_up_by_order" in results.mean:
        write_aux_flux_by_order(cfg.auxhist01_flux_file, results, grid)
        written.append(cfg.auxhist01_flux_file)
    if cfg.output_flux_file:
        write_flux_file(cfg.output_flux_file, results, grid)
        written.append(cfg.output_flux_file)
    if cfg.output_abs_prof_file:
        write_absorption_profile_file(cfg.output_abs_prof_file, results, grid)
        written.append(cfg.output_abs_prof_file)
    if cfg.output_abs_volume_file and "volume_absorption" in results.mean:
        write_volume_absorption_file(cfg.output_abs_volume_file, results, grid)
        written.append(cfg.output_abs_volume_file)
    if cfg.output_rad_file and "intensity" in results.mean:
        write_radiance_file(cfg.output_rad_file, results, grid)
        written.append(cfg.output_rad_file)
    if cfg.output_netcdf_file:
        from mcbrat3d_tpu_torch.driver.results_netcdf import write_results_netcdf
        write_results_netcdf(cfg.output_netcdf_file, results, grid)
        written.append(cfg.output_netcdf_file)
    return written
