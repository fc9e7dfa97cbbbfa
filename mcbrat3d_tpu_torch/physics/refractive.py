"""Complex refractive indices of water and ice vs wavelength + temperature.

PyTorch-port copy of ``mcbrat3d_tpu.physics.refractive`` (NumPy host code
of the offline table tools; the data file is the port's own copy). Full
re-implementation of the reference's REFWAT/REFICE routines
(reference: Tools/RefractiveIndex-IceAndWater.f:3-916) over the published
measured datasets, shipped in ``refractive_data.npz``:

  * liquid water, 0.2-1000 um: 518-point tables after Hale & Querry (1973),
    Palmer & Williams (1974), and Downing & Williams (1975); linear
    interpolation in wavelength (reference: :390-402),
  * liquid water, 0.1-10 cm: Ray (1972) extended-Debye permittivity with
    Saxton conductivity and Cole-Cole spread, temperature dependent, plus
    Ray's eqn-8 band corrections below 3 mm (reference: :404-428,468-474),
  * ice, 0.045-167 um: 468-point tables after Warren (1984);
    n interpolated vs log(lambda), log(k) vs log(lambda)
    (reference: :862-878),
  * ice, 167 um - 8.6 m: 62-point tables at four reference temperatures
    (272.16/268.16/253.16/213.16 K) interpolated in temperature and
    log(lambda) (reference: :880-909).

The data file carries measured physical constants (public datasets), not
code. The negative imaginary convention m = n - i*k matches the reference's
Mie usage (reference: Tools/MakeMieTable.f95:461).
"""

from __future__ import annotations

import functools
import os

import numpy as np

# Reference temperatures used when the caller does not pass one, matching
# MakeMieTable's constants (reference: Tools/MakeMieTable.f95:63-65).
WATER_TEMPERATURE_K = 283.0
ICE_TEMPERATURE_K = 243.0


@functools.lru_cache(maxsize=1)
def _data():
    path = os.path.join(os.path.dirname(__file__), "refractive_data.npz")
    return dict(np.load(path))


def refwat(lambda_um, temperature_k=WATER_TEMPERATURE_K):
    """Complex refractive index m = n - i*k of liquid water.

    Valid 0.2 um - 10 cm; temperature matters only beyond 0.1 cm
    (reference: Tools/RefractiveIndex-IceAndWater.f:3-428).
    """
    d = _data()
    lam = np.atleast_1d(np.asarray(lambda_um, np.float64))
    if np.any(lam < 0.2) or np.any(lam > 1.0e5):
        raise ValueError("water refractive index valid for 0.2 um - 10 cm")
    n = np.empty_like(lam)
    k = np.empty_like(lam)

    tab = lam <= 1000.0
    if np.any(tab):
        # linear interpolation in wavelength for both parts
        n[tab] = np.interp(lam[tab], d["water_wl"], d["water_rn"])
        k[tab] = np.interp(lam[tab], d["water_wl"], d["water_cn"])

    mw = ~tab
    if np.any(mw):
        wl = lam[mw]
        tc = float(temperature_k) - 273.15
        t1 = tc + 273.0
        t2 = tc - 25.0
        xl = wl / 1.0e4  # cm
        sigma = 12.5664e8
        alpha = -16.8129 / t1 + 0.0609265
        es = 78.54 * (1.0 - 4.579e-3 * t2 + 1.19e-5 * t2**2
                      - 2.8e-8 * t2**3)
        e00 = 5.27137 + 0.0216474 * tc - 0.00131198 * tc * tc
        lam_s = 0.00033836 * np.exp(2513.98 / t1)
        term = np.pi * alpha / 2.0
        lrat = lam_s / xl
        powtrm = lrat ** (1.0 - alpha)
        denom = 1.0 + 2.0 * powtrm * np.sin(term) + lrat ** (2.0 * (1.0 - alpha))
        er = e00 + (es - e00) * (1.0 + powtrm * np.sin(term)) / denom
        ei = (sigma * xl / 18.8496e10) + (es - e00) * powtrm * np.cos(term) / denom
        m = np.sqrt(er - 1j * ei)
        nn = m.real
        kk = -m.imag
        # remaining absorption bands below 3 mm (Ray eqn 8 / table 2)
        def band(wlc, bet, dele, gam):
            return bet * np.exp(-np.abs(np.log10(wl / wlc) / dele) ** gam)
        corr = np.where(wl <= 3000.0,
                        band(17.0, 0.39, 0.45, 1.3)
                        + band(62.0, 0.41, 0.35, 1.7)
                        + band(300.0, 0.25, 0.47, 3.0), 0.0)
        n[mw] = nn
        k[mw] = kk + corr

    out = n - 1j * k
    return out[0] if np.ndim(lambda_um) == 0 else out


def refice(lambda_um, temperature_k=ICE_TEMPERATURE_K):
    """Complex refractive index m = n - i*k of ice Ih.

    Valid 0.045 um - 8.6 m; temperature matters only beyond 167 um
    (reference: Tools/RefractiveIndex-IceAndWater.f:430-916).
    """
    d = _data()
    lam = np.atleast_1d(np.asarray(lambda_um, np.float64))
    if np.any(lam < 0.045) or np.any(lam > 8.6e6):
        raise ValueError("ice refractive index valid for 0.045 um - 8.6 m")
    n = np.empty_like(lam)
    k = np.empty_like(lam)
    loglam = np.log(lam)

    tab = lam <= 167.0
    if np.any(tab):
        lw = np.log(d["ice_wl"])
        n[tab] = np.interp(loglam[tab], lw, d["ice_re"])
        k[tab] = np.exp(np.interp(loglam[tab], lw, np.log(d["ice_im"])))

    mw = ~tab
    if np.any(mw):
        temref = d["ice_temref"]  # decreasing: 272.16 .. 213.16
        tk = min(max(float(temperature_k), temref[-1]), temref[0])
        # bracket the temperature (reference: :884-889)
        i_hi = int(np.searchsorted(-temref, -tk, side="right"))
        i_hi = min(max(i_hi, 1), 3)
        i_lo = i_hi - 1
        t_lo, t_hi = temref[i_hi], temref[i_lo]
        f = (tk - t_lo) / (t_hi - t_lo)
        lwt = np.log(d["ice_wlt"])
        n_lo = np.interp(loglam[mw], lwt, d["ice_tabret"][:, i_hi])
        n_hi = np.interp(loglam[mw], lwt, d["ice_tabret"][:, i_lo])
        n[mw] = n_lo + f * (n_hi - n_lo)
        k_lo = np.interp(loglam[mw], lwt, np.log(d["ice_tabimt"][:, i_hi]))
        k_hi = np.interp(loglam[mw], lwt, np.log(d["ice_tabimt"][:, i_lo]))
        k[mw] = np.exp(k_lo + f * (k_hi - k_lo))

    out = n - 1j * k
    return out[0] if np.ndim(lambda_um) == 0 else out


_REGISTRY = {}


def register_refractive_index(key: str, table: np.ndarray) -> None:
    """Register a custom (lambda_um, n_real, n_imag) table for a particle
    type key, overriding the built-in W/I datasets."""
    t = np.asarray(table, np.float64)
    if t.ndim != 2 or t.shape[1] != 3:
        raise ValueError("table must be [n, 3]: lambda_um, n_real, n_imag")
    _REGISTRY[key.upper()[:1]] = t


def refractive_index(particle_type: str, lambda_um, temperature_k=None):
    """Complex refractive index m = n - i*k for 'W'ater or 'I'ce.

    Temperature defaults follow the reference's MakeMieTable constants
    (283 K water, 243 K ice; reference: Tools/MakeMieTable.f95:63-65).
    """
    key = particle_type.upper()[:1]
    if key in _REGISTRY:
        t = _REGISTRY[key]
        lam = np.atleast_1d(np.asarray(lambda_um, np.float64))
        if np.any(lam < t[0, 0]) or np.any(lam > t[-1, 0]):
            raise ValueError(
                f"wavelength outside registered table range "
                f"[{t[0, 0]}, {t[-1, 0]}] um")
        n = np.interp(lam, t[:, 0], t[:, 1])
        k = np.exp(np.interp(np.log(lam), np.log(t[:, 0]),
                             np.log(t[:, 2])))
        out = n - 1j * k
        return out[0] if np.ndim(lambda_um) == 0 else out
    if key == "W":
        return refwat(lambda_um, temperature_k if temperature_k is not None
                      else WATER_TEMPERATURE_K)
    if key == "I":
        return refice(lambda_um, temperature_k if temperature_k is not None
                      else ICE_TEMPERATURE_K)
    raise ValueError(f"unknown particle type {particle_type!r}; "
                     "use 'W', 'I', or register a custom table")
