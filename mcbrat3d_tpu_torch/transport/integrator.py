"""Batch transport entry point of the PyTorch port.

Counterpart of ``mcbrat3d_tpu.transport.integrator``: ``KernelConfig``,
``Tallies`` and ``run_batch``, plus the analytic HG sampling and direction
rotation the record kernel's plain step uses. ``run_batch`` dispatches to
the record kernel (``transport.record_kernel``) or raises naming every
failing predicate: the XLA wave kernel, the JAX package's general
fallback, is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Static algorithm switches (reference: Drivers/monteCarloDriver.f95:
    110-118, the ``algorithms`` namelist)."""

    n_lanes: int = 1 << 17
    photons_per_lane: int = 8
    max_steps: int = 20_000
    use_ray_tracing: bool = False  # False -> maximum cross-section (Woodcock)
    use_russian_roulette: bool = True
    russian_roulette_weight: float = 1.0
    lw_mode: bool = False
    record_scattering_orders: int = 0
    # the full 3D absorption tally (reportVolumeAbsorption); without it and
    # without the profile the kernel tallies absorption per column
    need_volume_absorption: bool = True
    need_absorption_profile: bool = False

    @property
    def photons_per_batch(self) -> int:
        return self.n_lanes * self.photons_per_lane


@dataclasses.dataclass(frozen=True)
class Tallies:
    """Per-batch tallies (unnormalized photon weights, float32 tensors)."""

    flux_up: torch.Tensor  # [nx, ny]
    flux_down: torch.Tensor  # [nx, ny]
    flux_absorbed: torch.Tensor  # [nx, ny]
    volume_absorption: Optional[torch.Tensor]  # [nx, ny, nz] or None
    n_photons: int = 0  # photons started
    n_bad: int = 0  # photons still alive at the step cap
    n_steps: int = 0  # transport steps executed

    def normalized(self, grid: Grid) -> "Tallies":
        """Per-column normalization (reference:
        Integrators/monteCarloRadiativeTransfer.f95:326-389): fluxes divided
        by photons per column (weighted by column area); volume absorption
        also by cell depth * 1000 (km -> m)."""
        n = max(float(self.n_photons), 1.0)
        xe = grid.x_edges
        ye = grid.y_edges
        area = (xe[1:] - xe[:-1])[:, None] * (ye[1:] - ye[:-1])[None, :]
        per_col = n * (area / torch.sum(area))
        dz = grid.z_edges[1:] - grid.z_edges[:-1]
        return Tallies(
            flux_up=self.flux_up / per_col,
            flux_down=self.flux_down / per_col,
            flux_absorbed=self.flux_absorbed / per_col,
            volume_absorption=None if self.volume_absorption is None
            else self.volume_absorption
            / (per_col[:, :, None] * dz[None, None, :] * 1000.0),
            n_photons=self.n_photons, n_bad=self.n_bad,
            n_steps=self.n_steps)


def sample_hg_cos(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Analytic Henyey-Greenstein scattering cosine (exact inverse CDF),
    isotropic for |g| ~ 0."""
    small = g.abs() < 1e-5
    safe_g = torch.where(small, 1.0, g)
    s = (1.0 - g * g) / ((1.0 - g) + (2.0 * g) * u)
    ct = ((1.0 + g * g) - s * s) / (2.0 * safe_g)
    return torch.where(small, 2.0 * u - 1.0, ct.clamp(-1.0, 1.0))


def _sign(v: torch.Tensor) -> torch.Tensor:
    return torch.sign(torch.where(v == 0, 1.0, v))


def rotate_direction(ux, uy, uz, cos_theta, phi):
    """Rotate unit vectors by scattering angle theta with azimuth phi
    (analytic replacement of the reference's Marchuk construction,
    Integrators/monteCarloRadiativeTransfer.f95:1921-1948), with the
    |uz| >= 1e-4 guard and renormalization of the JAX kernel."""
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    denom = torch.sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
    safe = denom > 1e-6
    inv_denom = torch.where(safe, 1.0 / torch.clamp(denom, min=1e-12), 0.0)
    rx = ux * cos_theta + (sin_t * ((ux * uz) * cos_phi - uy * sin_phi)) * inv_denom
    ry = uy * cos_theta + (sin_t * ((uy * uz) * cos_phi + ux * sin_phi)) * inv_denom
    rz = uz * cos_theta - (sin_t * cos_phi) * denom
    sgn = _sign(uz)
    ox = torch.where(safe, rx, sin_t * cos_phi)
    oy = torch.where(safe, ry, (sgn * sin_t) * sin_phi)
    oz = torch.where(safe, rz, sgn * cos_theta)
    oz = torch.where(oz.abs() < 1e-4, _sign(oz) * 1e-4, oz)
    inv_norm = torch.rsqrt((ox * ox + oy * oy) + oz * oz)
    return ox * inv_norm, oy * inv_norm, oz * inv_norm


def run_batch(domain: OpticalDomain,
              surface: Surface,
              source: illumination.Source,
              seed: int,
              config: KernelConfig,
              n_photons: Optional[int] = None) -> Tallies:
    """Trace one batch of photons; return unnormalized tallies.

    ``seed`` is the batch's uint32 kernel seed (``core.rng.batch_seed``);
    results are deterministic in (seed, config) on the CPU. ``n_photons``
    overrides ``config.photons_per_batch`` (it must not exceed it)."""
    from mcbrat3d_tpu_torch.transport import record_kernel as rk

    reasons = rk.ineligibility_reasons(
        domain, surface, source, lw_mode=config.lw_mode,
        compute_intensity=False,
        record_scattering_orders=config.record_scattering_orders,
        use_ray_tracing=config.use_ray_tracing)
    nx, ny, nz = domain.grid.shape
    if (not reasons and nx * ny * nz > rk.TILE_MIN_CELLS
            and not config.need_volume_absorption
            and not config.need_absorption_profile):
        # the JAX package sends such dense domains to its tiled kernel
        # when that kernel has a tile plan for them; the port must not
        # silently run them on the record kernel instead
        reasons.append(
            f"{nx * ny * nz} cells > {rk.TILE_MIN_CELLS} without the 3D "
            "tally: the tiled dense-domain kernel (K5) takes this domain "
            "and is not ported yet")
    if reasons:
        raise NotImplementedError(
            "configuration outside the ported record kernel (and the XLA "
            "wave-kernel fallback is not ported yet); failing predicates: "
            + "; ".join(reasons))
    return rk.run_batch_record_tallies(domain, surface, source, seed, config,
                                       n_photons=n_photons)
