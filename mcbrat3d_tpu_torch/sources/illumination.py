"""Photon sources (PyTorch port): the directional solar beam, the beam
with a random azimuth, the isotropic (cosine-weighted) flux, the spotlight
(a slanted beam entering one point of the top) and thermal emission, either
per voxel (a Walker alias over every voxel) or backed by a separable
domain's tables.

Counterpart of ``mcbrat3d_tpu.sources.illumination`` (reference:
src/monteCarloIllumination.f95:62-216, 431-522). The transport kernel
samples the source on the fly when a photon starts, so a Source is a few
parameters (and, for per-voxel emission, its alias tables on the device).
The record kernel takes every kind but separable emission; the tiled
kernel every kind but emission; the column kernel directional, random
azimuth, flux and per-voxel emission (sampled from the domain's column
tables); the separable kernel those and both emission sources. The XLA
wave kernel (``transport.integrator``) samples every kind but separable
emission with ``sample``, on JAX's threefry streams.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.device import resolve

DIRECTIONAL = "directional"
RANDOM_AZIMUTH = "random_azimuth"
FLUX = "flux"
SPOTLIGHT = "spotlight"
EMISSION = "emission"

_TOP = float(np.float32(1.0 - 2.0 ** -23))  # z fraction just below the top
_MIN_MU = float(np.float32(1e-6))  # guard against horizontally trapped photons
_TWO_PI = float(np.float32(2.0 * np.pi))


@dataclasses.dataclass(frozen=True)
class Source:
    """Photon source parameters (float32 values held as Python floats)."""

    kind: str
    solar_mu: float = 0.0       # |mu0|; photons travel with mu = -|mu0|
    solar_azimuth: float = 0.0  # radians
    # emission: probability that a photon is emitted by the atmosphere
    # rather than the surface (fracAtmsPower), and the grid shape
    atms_fraction: float = 0.0
    grid_shape: tuple = None
    # emission sampled from the domain's separable tables (sep_em_*); only
    # the separable kernel samples such a source
    em_sep: bool = False
    # spotlight: the entry point as fractions of the domain's x and y size
    solar_x: float = 0.5
    solar_y: float = 0.5
    # per-voxel emission: the Walker alias pair in kernel cell order
    # (ix*ny + iy)*nz + iz, float32 tensors on the device (the alias
    # targets are exact below 2^24)
    em_prob: torch.Tensor = None
    em_alias: torch.Tensor = None


def directional(solar_mu: float, solar_azimuth_deg: float) -> Source:
    """Solar beam (reference: src/monteCarloIllumination.f95:62-101)."""
    if abs(solar_mu) > 1.0 or abs(solar_mu) < 1e-30:
        raise ValueError("solar_mu out of bounds")
    if not 0.0 <= solar_azimuth_deg <= 360.0:
        raise ValueError("solar azimuth out of bounds")
    return Source(kind=DIRECTIONAL,
                  solar_mu=float(np.float32(abs(solar_mu))),
                  solar_azimuth=float(np.float32(
                      np.deg2rad(solar_azimuth_deg))))


def random_azimuth(solar_mu: float) -> Source:
    """Beam at |mu0| with an azimuth drawn per photon."""
    if abs(solar_mu) > 1.0 or abs(solar_mu) < 1e-30:
        raise ValueError("solar_mu out of bounds")
    return Source(kind=RANDOM_AZIMUTH,
                  solar_mu=float(np.float32(abs(solar_mu))))


def flux() -> Source:
    """Isotropic downward flux: mu = -sqrt(u), azimuth uniform."""
    return Source(kind=FLUX)


def spotlight(solar_mu: float, solar_azimuth_deg: float,
              solar_x: float, solar_y: float) -> Source:
    """Beam at |mu0| and azimuth entering the top at one point, at the
    fractions (solar_x, solar_y) of the domain's x and y size (reference:
    src/monteCarloIllumination.f95:178-216)."""
    if not (0.0 < solar_x <= 1.0 and 0.0 < solar_y <= 1.0):
        raise ValueError("spotlight x/y must be in (0, 1]")
    return Source(kind=SPOTLIGHT,
                  solar_mu=float(np.float32(abs(solar_mu))),
                  solar_azimuth=float(np.float32(
                      np.deg2rad(solar_azimuth_deg))),
                  solar_x=float(np.float32(solar_x)),
                  solar_y=float(np.float32(solar_y)))


def emission(voxel_cdf, atms_fraction: float, grid_shape,
             device="cuda") -> Source:
    """Thermal emission source sampled per voxel (port of
    ``illumination.emission``; reference:
    src/monteCarloIllumination.f95:431-522).

    ``voxel_cdf``: [nz*ny*nx] cumulative power fractions (last entry 1),
    C-ordered as [nz, ny, nx] (``weights.emission_weighting``).
    ``atms_fraction``: probability that a photon is emitted by the
    atmosphere rather than the surface (fracAtmsPower). The record kernel
    draws the emitting voxel from a Walker alias table over every voxel in
    its cell order, built here on the host in float64 as the JAX package
    builds it and placed on ``device`` as float32."""
    nx, ny, nz = grid_shape
    cdf = np.asarray(voxel_cdf, np.float64)
    p = np.maximum(np.diff(cdf, prepend=0.0), 0.0)
    s = p.sum()
    p = p / s if s > 0 else np.full_like(p, 1.0 / p.size)
    # [nz, ny, nx] C-order -> kernel order (ix*ny + iy)*nz + iz
    pk = p.reshape(nz, ny, nx).transpose(2, 1, 0).reshape(-1)
    prob, alias = _walker_alias(pk)
    device = resolve(device)
    return Source(
        kind=EMISSION, atms_fraction=float(np.float32(atms_fraction)),
        grid_shape=(int(nx), int(ny), int(nz)),
        em_prob=torch.as_tensor(prob.astype(np.float32), device=device),
        em_alias=torch.as_tensor(alias.astype(np.float32), device=device))


def emission_separable(domain, surface_temp: float,
                       surface_emissivity: float) -> Source:
    """Thermal emission source backed by the domain's separable tables
    (port of ``illumination.emission_separable``).

    The separable kernel samples the emitting voxel from the domain's
    ``sep_em_*`` tables, so the source carries only the atmosphere/surface
    power split, exact in the factorized form:
      frac = atm / (atm + pi * emissivity * B(Tsfc))
    (fracAtmsPower; reference: src/monteCarloIllumination.f95:457-522).
    Needs a separable domain built with z-uniform temps and lambda_um > 0.
    """
    from mcbrat3d_tpu_torch.core.planck import planck_radiance

    if getattr(domain, "sep_em_zpa", None) is None:
        raise ValueError(
            "emission_separable needs a separable domain built with "
            "temps and lambda_um (domain.sep_em_zpa is None)")
    nx, ny, nz = domain.grid.shape
    # per-column mean, matching emission_weighting's
    # atms_power = atms_total * area / (nx*ny) vs pi*e*B*area
    atm = float(domain.sep_em_atm) / (nx * ny)
    if surface_emissivity > 0.0 and surface_temp > 0.0:
        sfc = np.pi * surface_emissivity * planck_radiance(
            float(domain.lambda_um), float(surface_temp))
    else:
        sfc = 0.0
    tot = atm + sfc
    frac = atm / tot if tot > 0.0 else 0.0
    return Source(kind=EMISSION, atms_fraction=float(np.float32(frac)),
                  grid_shape=(int(nx), int(ny), int(nz)), em_sep=True)


def _walker_alias(p: np.ndarray):
    """Vose's O(n) alias table of the distribution ``p`` (need not be
    normalized): sample j uniform in {0..n-1}, accept j with probability
    prob[j], else take alias[j].

    Builds the tables the JAX package builds with ``native/alias.cpp``
    (``illumination._walker_alias``): p scaled by n / sum(p), the sum taken
    left to right in float64, then the same stack order; leftovers accept
    with probability 1. Returns (prob f64, alias int64)."""
    p = np.ascontiguousarray(p, np.float64)
    n = p.size
    total = float(np.cumsum(p)[-1]) if n else 0.0
    # an empty or all-zero p makes alias.cpp refuse; the JAX package then
    # takes its Python fallback, which scales by n unnormalized
    scaled = p * (n / total) if total > 0.0 else p * n
    prob = np.zeros(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    scaled = scaled.tolist()
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = (scaled[l_i] + scaled[s_i]) - 1.0
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    for i in large:
        prob[i] = 1.0
    for i in small:  # numerical leftovers
        prob[i] = 1.0
    return prob, alias


def sample(source: Source, key: tuple, n: int, device):
    """Draw ``n`` photons for the XLA wave kernel: fractional (x, y, z)
    and the direction (mu, phi), float32 tensors on ``device``
    (``illumination.sample`` of the JAX package). Field i draws
    ``uniform(fold_in(key, i), n)`` on the threefry stream ``key``."""
    def u(i):
        return rng.uniform(rng.fold_in(key, i), n, device)

    def full(v):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    if source.kind == DIRECTIONAL:
        return (u(0), u(1), full(_TOP), full(-source.solar_mu),
                full(source.solar_azimuth))
    if source.kind == RANDOM_AZIMUTH:
        return (u(0), u(1), full(_TOP), full(-source.solar_mu),
                _TWO_PI * u(2))
    if source.kind == FLUX:
        # mu = -sqrt(u): daytime-average weighting
        # (reference: src/monteCarloIllumination.f95:142-176)
        return (u(0), u(1), full(_TOP),
                -torch.sqrt(torch.clamp(u(2), min=1e-12)), _TWO_PI * u(3))
    if source.kind == SPOTLIGHT:
        return (full(source.solar_x), full(source.solar_y), full(_TOP),
                full(-source.solar_mu), full(source.solar_azimuth))
    if source.kind == EMISSION:
        if source.em_sep:
            raise ValueError("a separable emission source is sampled by the "
                             "separable kernel only")
        return _sample_emission(source, [u(i) for i in range(7)], n, key,
                                device)
    raise ValueError(f"unknown source kind {source.kind!r}")


def _sample_emission(source: Source, u, n: int, key: tuple, device):
    """BBEmission (reference: src/monteCarloIllumination.f95:431-522): the
    atmosphere or the surface, the emitting voxel from the Walker alias
    (bin on stream 7, acceptance on stream 8; the table in kernel cell order
    (ix*ny + iy)*nz + iz), a uniform position inside it and an isotropic
    direction; surface photons leave from a uniform (x, y) at z = 0,
    Lambertian up. The azimuth has its own stream."""
    nx, ny, nz = source.grid_shape
    n_vox = nx * ny * nz
    from_atm = u[0] < source.atms_fraction
    bin_ = rng.randint(rng.fold_in(key, 7), n, n_vox, device)
    acc = rng.uniform(rng.fold_in(key, 8), n, device)
    prob = source.em_prob[bin_]
    alias = source.em_alias[bin_].long()
    flat = torch.clamp(torch.where(acc < prob, bin_, alias), 0, n_vox - 1)
    ii = flat // (ny * nz)
    ij = (flat // nz) % ny
    ik = flat % nz
    xf_a = (ii.to(torch.float32) + u[2]) / nx
    yf_a = (ij.to(torch.float32) + u[3]) / ny
    zf_a = torch.clamp((ik.to(torch.float32) + u[4]) / nz, 2.0 ** -24, _TOP)
    mu_a = 1.0 - 2.0 * u[5]
    mu_a = torch.where(mu_a.abs() < _MIN_MU,
                       torch.sign(mu_a + 1e-30) * _MIN_MU, mu_a)
    mu_s = torch.sqrt(torch.clamp(u[5], min=1e-12))
    xf = torch.where(from_atm, xf_a, u[1])
    yf = torch.where(from_atm, yf_a, u[2])
    zf = torch.where(from_atm, zf_a, torch.zeros_like(u[1]))
    mu = torch.where(from_atm, mu_a, mu_s)
    return xf, yf, zf, mu, _TWO_PI * u[6]
