"""Mie phase-function table generator.

PyTorch-port copy of ``mcbrat3d_tpu.tools.mie_table`` (NumPy host code, on
the port's ``physics.mie``). Re-design of the reference's MakeMieTable tool
(reference: Tools/MakeMieTable.f95): namelist-driven generation of a
phaseFunctionTable keyed by effective radius, from Mie theory over a gamma
or lognormal size distribution. The per-size Mie series runs in the native
C++ kernel (physics/mie.py); the distribution integration and Legendre
projection are dense NumPy linear algebra.

Pipeline (mirrors the reference's):
  1. center wavelength / Planck-weighted refractive index
     (reference: GET_CENTER_WAVELEN/GET_REFRACT_INDEX :376-461)
  2. size grid with size-parameter spacing dx = max(0.01, 0.03 sqrt(x))
     (reference: GET_NSIZE/GET_SIZES :466-520)
  3. Mie per size -> Qext, Qsca, intensity at Gauss-Legendre angles
  4. per Reff: size-distribution weights (gamma/lognormal at 1 g m^-3,
     Reff bisection; reference: MAKE_SIZE_DIST/DO_SIZE_DIST :599-717)
  5. distribution-averaged extinction [km^-1 / (g m^-3)], SSA and phase
     function -> Legendre moments truncated at 0.5e-5
     (reference: :199-201)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from mcbrat3d_tpu_torch.core.legendre import legendre_moments_from_values
from mcbrat3d_tpu_torch.core.planck import planck_radiance
from mcbrat3d_tpu_torch.physics.mie import mie_batch
from mcbrat3d_tpu_torch.physics.phase_function import PhaseFunction, PhaseFunctionTable
from mcbrat3d_tpu_torch.physics.refractive import refractive_index


@dataclasses.dataclass
class MieTableConfig:
    """Mirrors the reference's mie_table_input namelist
    (reference: Tools/MakeMieTable.f95:45-47)."""

    wavelen1: float = 0.55
    wavelen2: float = 0.0  # 0 -> monochromatic at wavelen1
    partype: str = "W"  # W(ater) | I(ce) | A(erosol via rindex)
    avgflag: str = "C"  # C: center wavelength; A: average over band
    deltawave: float = 0.003  # band-averaging step [um]
    rindex: Optional[complex] = None  # explicit index (partype A)
    pardens: float = 1.0  # particle density [g cm^-3]
    distflag: str = "G"  # G(amma) | L(ognormal)
    alpha: float = 7.0  # gamma shape / lognormal sigma
    nretanb: int = 0  # number of Reff entries
    sretab: float = 5.0  # smallest Reff [um]
    eretab: float = 25.0  # largest Reff [um]
    maxradius: float = 75.0  # largest particle radius [um]
    # Planck weighting temperature; None -> the reference's effective
    # blackbody rule (5800 K below 3 um, 270 K above 5 um, flat between;
    # reference: effectiveBlackBodyTemp, Tools/MakeMieTable.f95:298-323)
    bbtemp: Optional[float] = None
    max_legendre: int = 2048
    n_quad: int = 0  # 0 -> auto from max size parameter
    trunc_threshold: float = 0.5e-5


def effective_bb_temp(w1: float, w2: float) -> float:
    """Planck-weighting temperature for a band: 5800 K when the band center
    is below 3 um (solar), 270 K above 5 um (terrestrial), -1 (flat
    weighting) between (reference: effectiveBlackBodyTemp,
    Tools/MakeMieTable.f95:298-323)."""
    center = 0.5 * (w1 + w2)
    if center < 3.0:
        return 5800.0
    if center > 5.0:
        return 270.0
    return -1.0


def center_wavelength(w1: float, w2: float, bbtemp=None) -> float:
    """Planck-weighted center wavelength of [w1, w2]
    (reference: GET_CENTER_WAVELEN :376-414)."""
    if w2 <= w1:
        return w1
    if bbtemp is None:
        bbtemp = effective_bb_temp(w1, w2)
    lam = np.linspace(w1, w2, 201)
    wts = planck_radiance(lam, bbtemp) if bbtemp > 0 else np.ones_like(lam)
    return float(np.sum(lam * wts) / np.sum(wts))


def band_average_index(partype: str, w1: float, w2: float,
                       bbtemp: float, n_steps: int = 50) -> complex:
    """Planck-weighted refractive index over [w1, w2]
    (reference: GET_REFRACT_INDEX :416-461)."""
    lam = np.linspace(w1, w2, n_steps + 1)
    wts = planck_radiance(lam, bbtemp) if bbtemp > 0 else np.ones_like(lam)
    m = refractive_index(partype, lam)
    mre = float(np.sum(wts * m.real) / np.sum(wts))
    mim = float(np.sum(wts * (-m.imag)) / np.sum(wts))
    return complex(mre, -mim)


def size_grid(sretab: float, maxradius: float, wavelen: float) -> np.ndarray:
    """Radii with size-parameter spacing dx = max(0.01, 0.03 sqrt(x))
    (reference: GET_NSIZE/GET_SIZES :466-520)."""
    two_pi = 2.0 * np.pi
    radii = [0.02 * sretab]
    while radii[-1] < maxradius:
        x = two_pi * radii[-1] / wavelen
        delx = max(0.01, 0.03 * math.sqrt(x))
        radii.append(radii[-1] + delx * wavelen / two_pi)
    return np.asarray(radii)


def _delta_r(radii: np.ndarray) -> np.ndarray:
    """Geometric-mean bin widths (reference: DO_SIZE_DIST :690-697)."""
    d = np.empty_like(radii)
    d[1:-1] = (np.sqrt(radii[1:-1] * radii[2:])
               - np.sqrt(radii[1:-1] * radii[:-2]))
    d[0] = np.sqrt(radii[1] * radii[2]) - radii[0]
    d[-1] = radii[-1] - np.sqrt(radii[-1] * radii[-2])
    return d


def size_distribution(radii: np.ndarray, reff: float, alpha: float,
                      distflag: str, pardens: float):
    """Number concentrations [cm^-3] for LWC = 1 g m^-3 at the given
    *parameter* Reff; returns (nd, true_reff)
    (reference: DO_SIZE_DIST :668-717)."""
    dr = _delta_r(radii)
    if distflag.upper().startswith("G"):
        b = (alpha + 3.0) / reff
        nd = radii**alpha * np.exp(-b * radii) * dr
    else:
        b = reff * np.exp(-2.5 * alpha**2)
        nd = (1.0 / radii) * np.exp(
            -0.5 * (np.log(radii / b)) ** 2 / alpha**2) * dr
    sum2 = np.sum(nd * radii**2)
    sum3 = np.sum(nd * radii**3)
    true_reff = sum3 / sum2
    lwc = 1.0e-6 * pardens * (4.0 * np.pi / 3.0) * sum3
    return nd / lwc, true_reff


def adjusted_distribution(radii, reff, alpha, distflag, pardens,
                          tol: float = 1e-3, max_iter: int = 40):
    """Bisect the distribution's Reff parameter so the *discrete* effective
    radius matches the target (reference: MAKE_SIZE_DIST :599-666)."""
    nd, true_re = size_distribution(radii, reff, alpha, distflag, pardens)
    if abs(true_re - reff) < tol * reff:
        return nd
    lo, hi = reff * 0.3, reff * 3.0
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        nd, true_re = size_distribution(radii, mid, alpha, distflag, pardens)
        if abs(true_re - reff) < tol * reff:
            return nd
        if true_re < reff:
            lo = mid
        else:
            hi = mid
    raise ValueError(f"effective radius {reff} um cannot be achieved "
                     f"on this size grid (reached {true_re:.3f})")


def make_mie_table(cfg: MieTableConfig) -> PhaseFunctionTable:
    """Generate the phase-function table (the MakeMieTable main flow)."""
    bbtemp = (cfg.bbtemp if cfg.bbtemp is not None
              else effective_bb_temp(cfg.wavelen1,
                                     max(cfg.wavelen2, cfg.wavelen1)))
    wavelencen = center_wavelength(cfg.wavelen1, cfg.wavelen2, bbtemp)
    band_avg = cfg.avgflag.upper() == "A" and cfg.wavelen2 > cfg.wavelen1

    if cfg.rindex is not None:
        m = cfg.rindex
    elif cfg.wavelen2 > cfg.wavelen1 and not band_avg:
        m = band_average_index(cfg.partype, cfg.wavelen1,
                               cfg.wavelen2, bbtemp)
    else:
        m = complex(refractive_index(cfg.partype, wavelencen))

    radii = size_grid(cfg.sretab, cfg.maxradius, wavelencen)
    area = np.pi * radii**2  # geometric cross sections [um^2]

    if band_avg:
        # avgflag='A': Planck-weighted average of the *Mie computation*
        # over wavelengths spaced deltawave apart, with the water/ice
        # refractive index refreshed per wavelength (reference:
        # COMPUTE_MIE_ALL_SIZES, Tools/MakeMieTable.f95:523-595). The
        # phase-function average is weighted by the scattering cross
        # section: we accumulate the absolute differential cross section
        # inten * lambda^2 (dsigma/dOmega = i(theta)/k^2), which matches
        # the reference's Planck-weighted sum of SCAT * P_l.
        w_min = cfg.wavelen1
        n_quad = cfg.n_quad or min(
            4096, max(256, int(2.5 * 2.0 * np.pi * radii[-1] / w_min)))
        mu, wq = np.polynomial.legendre.leggauss(n_quad)
        cext = np.zeros(radii.size)
        csca = np.zeros(radii.size)
        inten = np.zeros((radii.size, n_quad))
        sum_p = 0.0
        wave = cfg.wavelen1
        while wave <= cfg.wavelen2 + 1e-9:
            planck = (planck_radiance(wave, bbtemp) if bbtemp > 0 else 1.0)
            if cfg.rindex is not None:
                m_w = cfg.rindex
            else:
                m_w = complex(refractive_index(cfg.partype, wave))
            qext_w, qsca_w, inten_w = mie_batch(
                2.0 * np.pi * radii / wave, m_w, mu)
            cext += planck * qext_w * area
            csca += planck * qsca_w * area
            inten += planck * (wave ** 2) * inten_w
            sum_p += planck
            wave += cfg.deltawave
        cext /= sum_p
        csca /= sum_p
        inten /= sum_p
    else:
        x = 2.0 * np.pi * radii / wavelencen
        x_max = float(x[-1])
        n_quad = cfg.n_quad or min(4096, max(256, int(2.5 * x_max)))
        mu, wq = np.polynomial.legendre.leggauss(n_quad)
        qext, qsca, inten = mie_batch(x, m, mu)
        cext = qext * area  # [um^2]
        csca = qsca * area

    n_reff = cfg.nretanb or max(2, int(round(cfg.eretab - cfg.sretab)) + 1)
    reffs = np.linspace(cfg.sretab, cfg.eretab, n_reff)

    pfs = []
    ext_out = np.empty(n_reff)
    ssa_out = np.empty(n_reff)
    max_x = 2.0 * np.pi * radii[-1] / wavelencen
    n_leg_cap = min(cfg.max_legendre, int(2 * max_x) + 32)

    for i, reff in enumerate(reffs):
        nd = adjusted_distribution(radii, reff, cfg.alpha, cfg.distflag,
                                   cfg.pardens)  # [cm^-3] at 1 g/m^3
        # volume extinction [km^-1] = sum nd [cm^-3] * cext [um^2] * 1e-3
        # (cm^-3 um^2 = 1e-12 cm^-1 * 1e5 km/cm... net factor 1e-3)
        ext_out[i] = np.sum(nd * cext) * 1.0e-3
        sca = np.sum(nd * csca) * 1.0e-3
        ssa_out[i] = sca / ext_out[i]

        # Distribution-averaged phase function: the scattered intensity per
        # solid angle of the ensemble is sum_i nd_i I_i(mu)/k^2 (same k for
        # all sizes), so P(mu) is proportional to sum_i nd_i I_i(mu);
        # normalize the quadrature integral over mu to exactly 2.
        p = np.einsum("s,sq->q", nd, inten)
        p *= 2.0 / np.sum(wq * p)

        moments = legendre_moments_from_values(mu, wq, p, n_leg_cap)
        # truncate trailing negligible moments (reference: :199-201)
        keep = np.nonzero(np.abs(moments) > cfg.trunc_threshold)[0]
        n_keep = (keep[-1] + 1) if keep.size else 1
        pfs.append(PhaseFunction(coefficients=moments[:n_keep],
                                 extinction=float(ext_out[i]),
                                 single_scattering_albedo=float(ssa_out[i])))

    return PhaseFunctionTable(
        pfs, key=reffs, extinction=ext_out,
        single_scattering_albedo=ssa_out,
        description=(f"Mie table {cfg.partype} lambda={wavelencen:.4f}um "
                     f"{cfg.distflag} alpha={cfg.alpha}"))


def main(namelist_path: str) -> int:
    """CLI: `mcbrat mie <namelist>` -- reads the reference's
    mie_table_input namelist and writes a phase-function table netCDF."""
    from mcbrat3d_tpu_torch.domain.io_netcdf import write_phase_function_table
    from mcbrat3d_tpu_torch.driver.config import parse_namelist

    with open(namelist_path) as f:
        groups = parse_namelist(f.read())
    nml = groups.get("mie_table_input", {})
    cfg = MieTableConfig(
        wavelen1=nml.get("wavelen1", 0.55),
        wavelen2=nml.get("wavelen2", 0.0),
        partype=str(nml.get("partype", "W")),
        avgflag=str(nml.get("avgflag", "C")),
        deltawave=nml.get("deltawave", 0.003),
        pardens=nml.get("pardens", 1.0),
        distflag=str(nml.get("distflag", "G")),
        alpha=nml.get("alpha", 7.0),
        nretanb=int(nml.get("nretab", 0)),
        sretab=nml.get("sretab", 5.0),
        eretab=nml.get("eretab", 25.0),
        maxradius=nml.get("maxradius", 75.0),
        max_legendre=int(nml.get("maxnleg", 2048)),
    )
    if "rindex_re" in nml:
        cfg.rindex = complex(nml["rindex_re"], -abs(nml.get("rindex_im", 0.0)))
    out = nml.get("mietabfile", "mie_table.pft")
    table = make_mie_table(cfg)
    write_phase_function_table(table, out)
    print(f"wrote {out}: {table.n_entries} entries, "
          f"lambda_cen={center_wavelength(cfg.wavelen1, cfg.wavelen2, cfg.bbtemp):.4f} um")
    return 0
