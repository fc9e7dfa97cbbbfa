"""Single-file netCDF results writer (same schema as the JAX driver's).

Equivalent of the reference's writeResults_netcdf (reference:
Drivers/monteCarloDriver.f95:1499-1807): one file with dims x/y/z(/dir),
mean + standard-error pairs for every quantity, and global attributes
carrying the full run provenance.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from mcbrat3d_tpu_torch.driver.run import Results


def write_results_netcdf(path: str, results: Results, grid) -> None:
    cfg = results.config
    m, s = results.mean, results.stderr
    nx, ny = m["flux_up"].shape
    # the profile is absent when neither reportVolumeAbsorption nor
    # reportAbsorptionProfile was requested (the record kernel's
    # flux_abs_2d path tallies no volume rows at all)
    nz = (m["absorption_profile"].size if "absorption_profile" in m
          else grid.nz)

    with netcdf_file(path, "w") as nc:
        nc.createDimension("x", nx)
        nc.createDimension("y", ny)
        nc.createDimension("z", nz)
        nc.createDimension("x-Edges", nx + 1)
        nc.createDimension("y-Edges", ny + 1)
        nc.createDimension("z-Edges", nz + 1)
        xe, ye, ze = grid.edges_np()
        nc.createVariable("x-Edges", "f8", ("x-Edges",))[:] = xe
        nc.createVariable("y-Edges", "f8", ("y-Edges",))[:] = ye
        nc.createVariable("z-Edges", "f8", ("z-Edges",))[:] = ze

        def put2(name, mean, err):
            nc.createVariable(name, "f8", ("y", "x"))[:] = mean.T
            nc.createVariable(name + "_StdErr", "f8", ("y", "x"))[:] = err.T

        put2("fluxUp", m["flux_up"], s["flux_up"])
        put2("fluxDown", m["flux_down"], s["flux_down"])
        put2("fluxAbsorbed", m["flux_absorbed"], s["flux_absorbed"])

        if "absorption_profile" in m:
            nc.createVariable("absorptionProfile", "f8", ("z",))[:] = (
                m["absorption_profile"])
            nc.createVariable(
                "absorptionProfile_StdErr", "f8", ("z",))[:] = (
                s["absorption_profile"])
        if "volume_absorption" in m:  # absent on the column-megakernel path
            nc.createVariable("absorbedVolume", "f8", ("z", "y", "x"))[:] = (
                m["volume_absorption"].T)
            nc.createVariable(
                "absorbedVolume_StdErr", "f8", ("z", "y", "x"))[:] = (
                s["volume_absorption"].T)

        # classic netCDF has no 64-bit attribute type; store as double
        nc.totalPhotons = np.float64(results.total_photons)
        nc.numBatches = np.int32(results.n_batches)
        nc.solarFlux = np.float64(results.solar_flux)
        if cfg is not None:
            nc.solarMu = np.float64(cfg.solar_mu)
            nc.solarAzimuth = np.float64(cfg.solar_azimuth)
            nc.iseed = np.int32(cfg.iseed)
            nc.useRayTracing = np.int32(cfg.use_ray_tracing)
            nc.useRussianRoulette = np.int32(cfg.use_russian_roulette)
