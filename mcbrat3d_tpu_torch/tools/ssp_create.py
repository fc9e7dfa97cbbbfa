"""Multi-wavelength SSP table builder.

PyTorch-port copy of ``mcbrat3d_tpu.tools.ssp_create``. Re-design of the
reference's MieSSPTableCreate tool (reference:
Tools/MieSSPTableCreate.f95): loop a Mie table computation over a frequency
grid and assemble the per-wavelength results into the single-scattering-
property netCDF the broadband solver consumes (schema: domain/ssp.py; the
reference's MPI round-robin over frequencies becomes a process pool /
simple loop -- this is offline tooling, not the transport path).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Sequence

import numpy as np

from mcbrat3d_tpu_torch.domain.ssp import SSPComponent, SSPTable, write_ssp_table
from mcbrat3d_tpu_torch.tools.mie_table import MieTableConfig, make_mie_table

C_LIGHT = 2.99792458e8


@dataclasses.dataclass
class SSPCreateConfig:
    """Inputs for one component's spectral table (mirrors the reference's
    namelist-driven per-frequency loop; reference:
    Tools/MieSSPTableCreate.f95:52-120)."""

    lambdas_um: Sequence[float]
    component_name: str = "cloud water"
    partype: str = "W"
    distflag: str = "G"
    alpha: float = 7.0
    pardens: float = 1.0
    sretab: float = 5.0
    eretab: float = 25.0
    n_reff: int = 21
    maxradius: float = 75.0
    surface_albedo: Optional[Sequence[float]] = None
    z_level_base: int = 0
    max_legendre: int = 2048
    n_workers: int = 0  # worker processes; 0 or 1 -> serial


def _one_lambda(args):
    lam, cfg = args
    mcfg = MieTableConfig(
        wavelen1=lam, partype=cfg.partype, distflag=cfg.distflag,
        alpha=cfg.alpha, pardens=cfg.pardens, sretab=cfg.sretab,
        eretab=cfg.eretab, nretanb=cfg.n_reff, maxradius=cfg.maxradius,
        max_legendre=cfg.max_legendre)
    return make_mie_table(mcfg)


def create_ssp_table(cfg: SSPCreateConfig) -> SSPTable:
    lams = np.asarray(cfg.lambdas_um, np.float64)
    nl = lams.size
    jobs = [(float(l), cfg) for l in lams]
    if cfg.n_workers and cfg.n_workers > 1:
        with ProcessPoolExecutor(
                max_workers=cfg.n_workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            tables = list(pool.map(_one_lambda, jobs))
    else:
        tables = [_one_lambda(j) for j in jobs]

    n_reff = tables[0].n_entries
    key = np.asarray(tables[0].key)
    ext = np.zeros((n_reff, nl))
    ssa = np.zeros((n_reff, nl))
    starts = np.zeros((n_reff, nl), np.int64)
    lengths = np.zeros((n_reff, nl), np.int64)

    per_lambda_coeffs = []
    for li, tbl in enumerate(tables):
        pos = 1
        chunks = []
        for e, pf in enumerate(tbl.phase_functions):
            c = np.asarray(pf.coefficients)
            if c.size == 0:
                c = np.zeros(1)
            starts[e, li] = pos
            lengths[e, li] = c.size
            chunks.append(c)
            pos += c.size
        ext[:, li] = tbl.extinction
        ssa[:, li] = tbl.single_scattering_albedo
        per_lambda_coeffs.append(np.concatenate(chunks))

    max_total = max(c.size for c in per_lambda_coeffs)
    coeffs = np.zeros((max_total, nl))
    for li, c in enumerate(per_lambda_coeffs):
        coeffs[: c.size, li] = c

    comp = SSPComponent(
        name=cfg.component_name, ext_type="volExt",
        z_level_base=cfg.z_level_base, key=key,
        extinction=ext, ssa=ssa,
        legendre_start=starts, legendre_length=lengths,
        legendre_coeffs=coeffs,
        description=f"Mie SSP {cfg.partype} {cfg.distflag} alpha={cfg.alpha}")
    albedo = (np.zeros(nl) if cfg.surface_albedo is None
              else np.asarray(cfg.surface_albedo, np.float64))
    return SSPTable(freq_hz=C_LIGHT * 1e6 / lams, surface_albedo=albedo,
                    components=[comp])


def main(namelist_path: str) -> int:
    """CLI hook: build an SSP table from a namelist with keys
    lambdas (um list), partype, distflag, alpha, sretab/eretab/nretab,
    maxradius, surfacealbedo, sspfile."""
    from mcbrat3d_tpu_torch.driver.config import parse_namelist
    with open(namelist_path) as f:
        groups = parse_namelist(f.read())
    nml = {}
    for g in groups.values():
        nml.update(g)
    lams = nml.get("lambdas")
    if lams is None:
        raise ValueError("namelist must provide lambdas (um)")
    if not isinstance(lams, list):
        lams = [lams]
    cfg = SSPCreateConfig(
        lambdas_um=lams,
        component_name=str(nml.get("componentname", "cloud water")),
        partype=str(nml.get("partype", "W")),
        distflag=str(nml.get("distflag", "G")),
        alpha=nml.get("alpha", 7.0),
        pardens=nml.get("pardens", 1.0),
        sretab=nml.get("sretab", 5.0),
        eretab=nml.get("eretab", 25.0),
        n_reff=int(nml.get("nretab", 21)),
        maxradius=nml.get("maxradius", 75.0),
        surface_albedo=nml.get("surfacealbedo"),
        n_workers=int(nml.get("nworkers", 0)),
    )
    sa = cfg.surface_albedo
    if sa is not None and not isinstance(sa, list):
        cfg.surface_albedo = [sa] * len(lams)
    out = nml.get("sspfile", "ssp_table.nc")
    write_ssp_table(out, create_ssp_table(cfg))
    print(f"wrote {out}: {len(lams)} wavelengths")
    return 0
