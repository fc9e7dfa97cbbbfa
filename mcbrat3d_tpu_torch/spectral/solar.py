"""Solar source function and spectral response function files (PyTorch
port; a copy of ``mcbrat3d_tpu.spectral.solar``, numpy and scipy only).

Reference schemas: solar source files carry dim/var 'Lambdas' and
'SourceFunction' (reference: read_SolarSource,
src/emissionAndBroadBandWeights.f95:598-633); spectral response files carry
'Lambdas' and 'SRF' (:635-662).
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file


def write_solar_source(path: str, lambdas_um, source_function) -> None:
    lam = np.asarray(lambdas_um, np.float64)
    src = np.asarray(source_function, np.float64)
    with netcdf_file(path, "w") as nc:
        nc.createDimension("Lambdas", lam.size)
        nc.createVariable("Lambdas", "f8", ("Lambdas",))[:] = lam
        nc.createVariable("SourceFunction", "f8", ("Lambdas",))[:] = src


def read_solar_source(path: str, n_lambda=None):
    with netcdf_file(path, "r", mmap=False) as nc:
        lam = np.array(nc.variables["Lambdas"][:], np.float64)
        src = np.array(nc.variables["SourceFunction"][:], np.float64)
    if n_lambda is not None and lam.size != n_lambda:
        raise ValueError(f"solar source has {lam.size} lambdas, "
                         f"namelist says {n_lambda}")
    return lam, src


def write_spectral_response(path: str, lambdas_um, srf) -> None:
    lam = np.asarray(lambdas_um, np.float64)
    with netcdf_file(path, "w") as nc:
        nc.createDimension("Lambdas", lam.size)
        nc.createVariable("Lambdas", "f8", ("Lambdas",))[:] = lam
        nc.createVariable("SRF", "f8", ("Lambdas",))[:] = np.asarray(
            srf, np.float64)


def read_spectral_response(path: str, n_lambda=None):
    with netcdf_file(path, "r", mmap=False) as nc:
        srf = np.array(nc.variables["SRF"][:], np.float64)
    if n_lambda is not None and srf.size != n_lambda:
        raise ValueError(f"SRF has {srf.size} lambdas, namelist {n_lambda}")
    return srf
