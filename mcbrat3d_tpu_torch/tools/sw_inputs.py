#!/usr/bin/env python3
"""Inputs of the broadband-SW deck ``run/broadband_sw.nml``.

    python3 mcbrat3d_tpu_torch/tools/sw_inputs.py [DIR]

Writes ``common_sw.nc``, ``ssp_solar.nc`` and ``solar.nc`` into DIR
(default: the current directory): bench.py:576-650's scene. 16 bins at
0.4-1.0 um; one cloud-water component of 5 Reff keys (5-25 um) whose
mass extinction is 2 + 0.5 u and ssa 0.99, each row a 128-term Legendre
mixture 0.7 g^l + 0.3 0.3^l (g = 0.78 + 0.03 e + 0.005 lambda index);
32 x 32 x 32 cells of 0.5/32 x 0.5/32 x 0.25/32 km, the cloud's mass 1
g m^-3 in the lower half and 9 in the upper, Reff 10 + 8 u per cell; air
at 280 K, 1.2 kg m^-3 and 2.55e25 molecules m^-3 (written as the pressure
that gives it), so with calcRayl the bins have 2 components; the solar
source 1000 exp(-((lambda - 0.55) / 0.3)^2). The uniforms u are drawn from
numpy's RandomState(7) in bench.py's order. 32,768 cells: within the
record kernel's envelope. Built on the host: the files are all it makes.
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np

SCENE = dict(n=32, n_lambda=16, n_reff=5, seed=7)
C_LIGHT = 2.99792458e8
TEMP_K, RHO, NUM_CONC = 280.0, 1.2, 2.55e25


def write_sw_broadband_inputs(directory=".", n=32, n_lambda=16, n_reff=5,
                              seed=7):
    """Write the deck's ``common_sw.nc``, ``ssp_solar.nc`` and
    ``solar.nc`` into ``directory`` and return their paths; the arguments
    cut the grid (n^3 cells) and the bins for tests."""
    from mcbrat3d_tpu_torch.core.grid import Grid
    from mcbrat3d_tpu_torch.domain.common import (CommonDomain, N_AVOGADRO,
                                                  R_STAR, write_common)
    from mcbrat3d_tpu_torch.domain.ssp import (SSPComponent, SSPTable,
                                               write_ssp_table)
    from mcbrat3d_tpu_torch.spectral.solar import write_solar_source

    lambdas = np.linspace(0.4, 1.0, n_lambda)
    rs = np.random.RandomState(seed)
    starts = np.zeros((n_reff, n_lambda))
    lengths = np.zeros((n_reff, n_lambda))
    cmat = np.zeros((n_reff * 128, n_lambda))
    l = np.arange(1, 129, dtype=np.float64)
    for li in range(n_lambda):
        for e in range(n_reff):
            g1 = 0.78 + 0.03 * e + 0.005 * li
            cmat[e * 128:(e + 1) * 128, li] = 0.7 * g1**l + 0.3 * 0.3**l
            starts[e, li] = 1 + 128 * e
            lengths[e, li] = 128
    comp = SSPComponent(
        name="cloud water", ext_type="volExt",
        key=np.linspace(5.0, 25.0, n_reff),
        extinction=2.0 + 0.5 * rs.rand(n_reff, n_lambda),
        ssa=np.full((n_reff, n_lambda), 0.99),
        legendre_start=starts, legendre_length=lengths,
        legendre_coeffs=cmat)
    table = SSPTable(freq_hz=C_LIGHT * 1e6 / lambdas,
                     surface_albedo=np.zeros(n_lambda), components=[comp])

    grid = Grid.regular(n, n, n, 0.5 / n, 0.5 / n, 0.25 / n, device="cpu")
    mass = np.zeros((1, n, n, n))
    mass[0, :, :, :n // 2] = 1.0
    mass[0, :, :, n // 2:] = 9.0
    reff = np.full((1, n, n, n), 10.0 + 8.0 * rs.rand(n, n, n))
    temps = np.full((n, n, n), TEMP_K)
    common = CommonDomain(grid=grid, temps=temps,
                          rho=np.full((n, n, n), RHO),
                          num_conc=np.full((n, n, n), NUM_CONC),
                          mass_conc=mass, reff=reff)
    # the reader rebuilds the number density from the pressure
    pressure_hpa = np.full(n, NUM_CONC * R_STAR * TEMP_K
                           / (N_AVOGADRO * 100.0))
    os.makedirs(directory, exist_ok=True)
    paths = [os.path.join(directory, f)
             for f in ("common_sw.nc", "ssp_solar.nc", "solar.nc")]
    write_common(paths[0], common, pressure_hpa=pressure_hpa)
    write_ssp_table(paths[1], table)
    write_solar_source(paths[2], lambdas.tolist(),
                       (1000.0 * np.exp(-((lambdas - 0.55) / 0.3) ** 2))
                       .tolist())
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("directory", nargs="?", default=".")
    args = ap.parse_args()
    for p in write_sw_broadband_inputs(args.directory):
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    sys.exit(main())
