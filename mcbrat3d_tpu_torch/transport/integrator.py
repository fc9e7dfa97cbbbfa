"""Batch transport entry point of the PyTorch port.

Counterpart of ``mcbrat3d_tpu.transport.integrator``: ``KernelConfig``,
``Tallies`` and ``run_batch``, plus the analytic HG sampling and direction
rotation the plain steps use. ``run_batch`` dispatches in the JAX
package's order (``integrator._run_batch_impl``): the record kernel
(``transport.record_kernel``: 1-3 components, the directional,
random-azimuth, flux and spotlight sources and per-voxel thermal emission
with the lw_mode pre-credits), with in-kernel radiance when
radiance directions are given, the column kernel's local estimate where the
record kernel's refuses a radiance run (grids above ``MAX_KERNEL_DIRS`` run
as direction-chunked passes over the same photons), then for flux runs the
column-template kernel (``transport.col_kernel``), the separable-template
kernel (``transport.sep_kernel``) and the tiled dense-domain kernel
(``transport.tile_kernel``), or raises naming every failing predicate: the
XLA wave kernel, the JAX package's general fallback, is not ported yet. A
record-eligible domain of more than ``TILE_MIN_CELLS`` cells skips the
record kernel when the tiled kernel takes it, so a small domain of any
size below that stays on the record kernel whatever its source or
component count, as in the JAX package. A compact domain or a separable
emission source must reach the separable kernel. ``select_kernel`` holds
that order; ``spectral.broadband`` asks it whether a bin runs on the
separable kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le


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
    intensity: Optional[torch.Tensor] = None  # [nx, ny, n_dirs] or None
    n_photons: int = 0  # photons started
    n_bad: int = 0  # photons alive at the step cap + n_cut
    n_steps: int = 0  # transport steps executed
    n_cut: int = 0  # radiance marches cut by the iteration bound
    # z marginal of the absorption [nz], tallied by the column kernel
    absorption_profile: Optional[torch.Tensor] = None
    n_lane_steps: int = 0  # lane-steps run with a live photon
    n_passes: int = 0  # sort + transport passes of the tiled kernel
    n_real: int = 0  # real collisions (record and tiled kernels)
    # the local estimate of the record and column kernels: events (real
    # collisions, reflections and, with LW radiance, births) and march or
    # column-walk iterations over all directions
    n_le_events: int = 0
    n_walk: int = 0
    n_atm_births: int = 0  # atmospheric emission births (column kernel)

    def normalized(self, grid: Grid) -> "Tallies":
        """Per-column normalization (reference:
        Integrators/monteCarloRadiativeTransfer.f95:326-389): fluxes and
        intensity divided by photons per column (weighted by column area);
        volume absorption also by cell depth * 1000 (km -> m); the
        absorption profile (the horizontal mean of that field) by the
        photon count times cell depth * 1000."""
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
            intensity=None if self.intensity is None
            else self.intensity / per_col[:, :, None],
            absorption_profile=None if self.absorption_profile is None
            else self.absorption_profile / (n * dz * 1000.0),
            n_photons=self.n_photons, n_bad=self.n_bad,
            n_steps=self.n_steps, n_cut=self.n_cut,
            n_lane_steps=self.n_lane_steps, n_passes=self.n_passes,
            n_real=self.n_real, n_le_events=self.n_le_events,
            n_walk=self.n_walk, n_atm_births=self.n_atm_births)


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


def select_kernel(domain: OpticalDomain, surface: Surface,
                  source: illumination.Source, config: KernelConfig,
                  intensity_config: Optional[le.IntensityConfig] = None,
                  intensity_dirs: Optional[torch.Tensor] = None):
    """The kernel ``run_batch`` runs this batch on, in the JAX package's
    order (``integrator._run_batch_impl``): ``"record"``, ``"col"``,
    ``"sep"`` or ``"tile"``, or None when no ported kernel takes it.
    Returns ``(kernel, reasons)``; ``reasons`` maps each kernel tried
    before (or instead of) the chosen one to its failing predicates. With
    ``intensity_config`` the record kernel's local estimate comes first,
    then the column kernel's (integrator.py:413-448); a grid above
    ``MAX_KERNEL_DIRS`` is judged by its first chunk, which ``run_batch``
    runs like every other.

    Raises NotImplementedError where it picks the record kernel for a
    surface the port's record kernel does not reflect off yet (K1-d: a
    uniform RPV surface or a per-pixel Lambertian grid within its 4,096
    columns), rather than hand the batch to a later kernel."""
    from mcbrat3d_tpu_torch.transport import record_kernel as rk

    kernel, reasons = _pick_kernel(domain, surface, source, config,
                                   intensity_config, intensity_dirs)
    if kernel == "record":
        rk.check_surface_ported(surface)
    return kernel, reasons


def _pick_kernel(domain, surface, source, config, intensity_config,
                 intensity_dirs):
    """``select_kernel``'s choice, before its K1-d check."""
    from mcbrat3d_tpu_torch.transport import col_kernel as ck
    from mcbrat3d_tpu_torch.transport import record_kernel as rk
    from mcbrat3d_tpu_torch.transport import sep_kernel as sk
    from mcbrat3d_tpu_torch.transport import tile_kernel as tk

    if intensity_config is not None:
        if intensity_config.n_dirs > le.MAX_KERNEL_DIRS:
            intensity_config = dataclasses.replace(
                intensity_config, n_dirs=le.MAX_KERNEL_DIRS)
            intensity_dirs = intensity_dirs[:, :le.MAX_KERNEL_DIRS]
        reasons = {"record": rk.intensity_ineligibility_reasons(
            domain, surface, source, config.lw_mode,
            config.record_scattering_orders, config.use_ray_tracing,
            intensity_config, intensity_dirs)}
        if not reasons["record"]:
            return "record", reasons
        reasons["col"] = ck.col_intensity_ineligibility_reasons(
            domain, surface, source, config.lw_mode,
            config.record_scattering_orders, config.use_ray_tracing,
            intensity_config, intensity_dirs,
            config.need_volume_absorption)
        return (None if reasons["col"] else "col"), reasons

    reasons = {"record": rk.ineligibility_reasons(
        domain, surface, source, lw_mode=config.lw_mode,
        compute_intensity=False,
        record_scattering_orders=config.record_scattering_orders,
        use_ray_tracing=config.use_ray_tracing)}
    kernel_args = dict(
        lw_mode=config.lw_mode, compute_intensity=False,
        record_scattering_orders=config.record_scattering_orders,
        use_ray_tracing=config.use_ray_tracing,
        need_volume_absorption=config.need_volume_absorption)
    tile_reasons = tk.tile_ineligibility_reasons(
        domain, surface, source,
        need_absorption_profile=config.need_absorption_profile,
        **kernel_args)
    nx, ny, nz = domain.grid.shape
    if (not reasons["record"] and nx * ny * nz > tk.TILE_MIN_CELLS
            and not tile_reasons):
        # past 16,384 cells the JAX package skips the record kernel for a
        # domain its tiled kernel takes, and tries the column and separable
        # kernels first (integrator.py:455-471)
        reasons["record"].append(
            f"{nx * ny * nz} cells > {tk.TILE_MIN_CELLS} and the tiled "
            "dense-domain kernel (K5) takes this domain")
    if not reasons["record"]:
        return "record", reasons
    reasons["col"] = ck.col_ineligibility_reasons(domain, surface, source,
                                                  **kernel_args)
    if not reasons["col"]:
        return "col", reasons
    reasons["sep"] = sk.sep_ineligibility_reasons(domain, surface, source,
                                                  **kernel_args)
    if not reasons["sep"]:
        return "sep", reasons
    reasons["tile"] = tile_reasons
    return ("tile" if not tile_reasons else None), reasons


def run_batch(domain: OpticalDomain,
              surface: Surface,
              source: illumination.Source,
              seed: int,
              config: KernelConfig,
              n_photons: Optional[int] = None,
              intensity_config: Optional[le.IntensityConfig] = None,
              intensity_dirs: Optional[torch.Tensor] = None) -> Tallies:
    """Trace one batch of photons; return unnormalized tallies.

    ``seed`` is the batch's uint32 kernel seed (``core.rng.batch_seed``);
    results are deterministic in (seed, config) on the CPU. ``n_photons``
    overrides ``config.photons_per_batch`` (it must not exceed it). With
    ``intensity_config`` and ``intensity_dirs`` ([3, n_dirs]) the tallies
    carry the top-of-domain radiance image [nx, ny, n_dirs]. The kernel is
    ``select_kernel``'s."""
    from mcbrat3d_tpu_torch.transport import col_kernel as ck
    from mcbrat3d_tpu_torch.transport import record_kernel as rk
    from mcbrat3d_tpu_torch.transport import sep_kernel as sk
    from mcbrat3d_tpu_torch.transport import tile_kernel as tk

    if (intensity_config is not None
            and intensity_config.n_dirs > le.MAX_KERNEL_DIRS):
        return _run_batch_dir_chunked(domain, surface, source, seed, config,
                                      intensity_config, intensity_dirs,
                                      n_photons)
    kernel, reasons = select_kernel(domain, surface, source, config,
                                    intensity_config, intensity_dirs)
    if kernel == "record":
        return rk.run_batch_record_tallies(
            domain, surface, source, seed, config, n_photons=n_photons,
            intensity_config=intensity_config, intensity_dirs=intensity_dirs)
    if kernel == "col":
        return ck.run_batch_col_tallies(
            domain, surface, source, seed, config, n_photons=n_photons,
            intensity_config=intensity_config, intensity_dirs=intensity_dirs)
    run = {"sep": sk.run_batch_sep_tallies,
           "tile": tk.run_batch_tile_tallies}.get(kernel)
    if run is not None:
        return run(domain, surface, source, seed, config, n_photons=n_photons)
    if intensity_config is not None:
        raise NotImplementedError(
            "radiance configuration outside the ported record and column "
            "kernels (and the XLA local estimator is not ported yet); "
            "failing record-kernel predicates: "
            + "; ".join(reasons["record"])
            + "; failing column-kernel predicates: "
            + "; ".join(reasons["col"]))
    if domain.cell_records is None or source.em_sep:
        # compact domains and separable emission sources carry no per-cell
        # fields: only the separable kernel runs them
        # (integrator.py:539-554)
        what = ("domain was built with device_fields='compact'"
                if domain.cell_records is None
                else "source is emission_separable")
        raise ValueError(
            f"{what}, which only the separable kernel supports, but the run "
            "did not dispatch there; failing predicates: "
            + "; ".join(reasons["sep"]))
    raise NotImplementedError(
        "configuration outside the ported record, column, separable and "
        "tiled kernels (and the XLA wave-kernel fallback is not ported "
        "yet); failing record-kernel predicates: "
        + "; ".join(reasons["record"])
        + "; failing column-kernel predicates: " + "; ".join(reasons["col"])
        + "; failing separable-kernel predicates: "
        + "; ".join(reasons["sep"])
        + "; failing tiled-kernel (K5) predicates: "
        + "; ".join(reasons["tile"]))


def _run_batch_dir_chunked(domain, surface, source, seed, config, icfg,
                           dirs, n_photons) -> Tallies:
    """Direction-chunked radiance (port of
    ``integrator._run_batch_dir_chunked``): split a grid of more than
    ``MAX_KERNEL_DIRS`` directions into kernel-sized passes over the SAME
    photons (same seed, so the same paths). Fluxes are identical across
    chunks and chunk 0's are kept; the images are concatenated, and
    ``n_bad`` adds every later chunk's cut marches to chunk 0's. Directions
    of different chunks share roulette sites, a correlation of the same
    order as the path sharing all directions already have."""
    max_dirs = le.MAX_KERNEL_DIRS
    parts = []
    for lo in range(0, icfg.n_dirs, max_dirs):
        hi = min(icfg.n_dirs, lo + max_dirs)
        parts.append(run_batch(domain, surface, source, seed, config,
                               n_photons,
                               dataclasses.replace(icfg, n_dirs=hi - lo),
                               dirs[:, lo:hi]))
    n_cut_later = sum(t.n_cut for t in parts[1:])
    return dataclasses.replace(
        parts[0], intensity=torch.cat([t.intensity for t in parts], dim=-1),
        n_bad=parts[0].n_bad + n_cut_later,
        n_cut=parts[0].n_cut + n_cut_later)
