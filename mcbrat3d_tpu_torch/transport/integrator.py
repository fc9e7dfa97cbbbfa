"""Batch transport entry point of the PyTorch port.

Counterpart of ``mcbrat3d_tpu.transport.integrator``: ``KernelConfig``,
``Tallies``, ``run_batch`` and the ``Integrator`` wrapper, the analytic HG
sampling and direction rotation the plain steps use, and the XLA wave
kernel, the JAX package's general path. ``run_batch`` dispatches in the
JAX package's order (``integrator._run_batch_impl``): the record kernel
(``transport.record_kernel``: 1-3 components, the directional,
random-azimuth, flux and spotlight sources and per-voxel thermal emission
with the lw_mode pre-credits; a uniform Lambertian or RPV surface or a
per-pixel Lambertian grid), with in-kernel radiance when radiance
directions are given, the column kernel's local estimate where the record
kernel's refuses a radiance run (grids above ``MAX_KERNEL_DIRS`` run as
direction-chunked passes over the same photons), then for flux runs the
column-template kernel (``transport.col_kernel``), the separable-template
kernel (``transport.sep_kernel``) and the tiled dense-domain kernel
(``transport.tile_kernel``). A batch that none of them takes runs on the
wave kernel (``KernelConfig.use_pallas`` "auto"); "off" runs every batch
there and "on" raises instead, naming every failing predicate. A
record-eligible domain of more than ``TILE_MIN_CELLS`` cells skips the
record kernel when the tiled kernel takes it, so a small domain of any
size below that stays on the record kernel whatever its source or
component count, as in the JAX package. A compact domain or a separable
emission source must reach the separable kernel. ``select_kernel`` holds
that order; ``spectral.broadband`` asks it whether a bin runs on the
separable kernel.

The wave kernel (``run_wave_kernel``) advances ``n_lanes`` photons
together, a Python loop over steps whose state lives as tensors on the
domain's device: refill from the source, a Woodcock step against the
carried macro majorant (or a DDA march with ``use_ray_tracing``), the
component choice and absorption, the local estimate, roulette, scattering,
the surface (Lambertian, RPV, per pixel), the fused tally and the
per-order tallies, then the tail compaction. It draws JAX's threefry
streams (``core.rng.step_key``), so at JAX's batch key it follows the JAX
package's paths; it syncs with the host once a step, for the loop's test.
It is plain PyTorch, as the JAX package computes it outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import dda
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport.tally import make_accumulator


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
    max_dda_crossings: int = 0  # 0 -> auto (4 * (nx+ny+nz) + 64)
    # per-scattering-order boundary-flux tallies (recScatOrd): orders
    # 0..K-1 plus an overflow bin (reference:
    # Drivers/monteCarloDriver.f95:98-99); the wave kernel tallies them
    record_scattering_orders: int = 0
    # the wave kernel compacts its stragglers into a 16x smaller wave once
    # every quota is spent (statistics unchanged)
    tail_compaction: bool = True
    # "auto": the hand-written kernels where one takes the batch, else the
    # wave kernel; "on": raise where none does; "off": the wave kernel
    use_pallas: str = "auto"
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
    # boundary fluxes by scattering order [nx, ny, K+1] (wave kernel)
    flux_up_by_order: Optional[torch.Tensor] = None
    flux_down_by_order: Optional[torch.Tensor] = None

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
            flux_up_by_order=None if self.flux_up_by_order is None
            else self.flux_up_by_order / per_col[:, :, None],
            flux_down_by_order=None if self.flux_down_by_order is None
            else self.flux_down_by_order / per_col[:, :, None],
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
    runs like every other."""
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


def _refusal(reasons: dict) -> str:
    names = {"record": "record-kernel", "col": "column-kernel",
             "sep": "separable-kernel", "tile": "tiled-kernel (K5)"}
    return "; ".join(f"failing {names[k]} predicates: " + "; ".join(v)
                     for k, v in reasons.items())


def run_batch(domain: OpticalDomain,
              surface: Surface,
              source: illumination.Source,
              seed: int,
              config: KernelConfig,
              n_photons: Optional[int] = None,
              intensity_config: Optional[le.IntensityConfig] = None,
              intensity_dirs: Optional[torch.Tensor] = None,
              key: Optional[tuple] = None,
              debug_state: bool = False) -> Tallies:
    """Trace one batch of photons; return unnormalized tallies.

    ``seed`` is the batch's uint32 kernel seed (``core.rng.batch_seed``)
    and ``key`` its threefry key (``core.rng.batch_key(iseed, b)``), which
    the wave kernel needs (it raises ``ValueError`` without one) and the
    hand-written kernels do not read; results are deterministic in (seed,
    key, config) on the CPU. ``n_photons`` overrides
    ``config.photons_per_batch`` (it must not exceed it). With
    ``intensity_config`` and ``intensity_dirs`` ([3, n_dirs]) the tallies
    carry the top-of-domain radiance image [nx, ny, n_dirs]. The kernel is
    ``select_kernel``'s under ``config.use_pallas`` "auto" and "on", the
    wave kernel where it names none ("auto") or always ("off");
    ``debug_state`` runs the wave kernel and returns its final lane state
    (a dict of tensors), as the JAX package's does."""
    from mcbrat3d_tpu_torch.transport import col_kernel as ck
    from mcbrat3d_tpu_torch.transport import record_kernel as rk
    from mcbrat3d_tpu_torch.transport import sep_kernel as sk
    from mcbrat3d_tpu_torch.transport import tile_kernel as tk

    if config.use_pallas not in ("auto", "on", "off"):
        raise ValueError(f"use_pallas must be 'auto', 'on' or 'off', got "
                         f"{config.use_pallas!r}")
    kernel, reasons = None, {}
    if config.use_pallas != "off" and not debug_state:
        kernel, reasons = select_kernel(domain, surface, source, config,
                                        intensity_config, intensity_dirs)
    if kernel is not None:
        if (intensity_config is not None
                and intensity_config.n_dirs > le.MAX_KERNEL_DIRS):
            return _run_batch_dir_chunked(domain, surface, source, seed,
                                          config, intensity_config,
                                          intensity_dirs, n_photons, key)
        if kernel == "record":
            return rk.run_batch_record_tallies(
                domain, surface, source, seed, config, n_photons=n_photons,
                intensity_config=intensity_config,
                intensity_dirs=intensity_dirs)
        if kernel == "col":
            return ck.run_batch_col_tallies(
                domain, surface, source, seed, config, n_photons=n_photons,
                intensity_config=intensity_config,
                intensity_dirs=intensity_dirs)
        run = {"sep": sk.run_batch_sep_tallies,
               "tile": tk.run_batch_tile_tallies}[kernel]
        return run(domain, surface, source, seed, config, n_photons=n_photons)
    if config.use_pallas == "on":
        raise ValueError(
            "use_pallas='on' but the configuration is outside every "
            "hand-written kernel's envelope; " + _refusal(reasons))
    if domain.cell_records is None or source.em_sep:
        # compact domains and separable emission sources carry no per-cell
        # fields: only the separable kernel runs them
        # (integrator.py:539-554)
        what = ("domain was built with device_fields='compact'"
                if domain.cell_records is None
                else "source is emission_separable")
        sep = reasons.get("sep") or sk.sep_ineligibility_reasons(
            domain, surface, source, lw_mode=config.lw_mode,
            compute_intensity=intensity_config is not None,
            record_scattering_orders=config.record_scattering_orders,
            use_ray_tracing=config.use_ray_tracing,
            need_volume_absorption=config.need_volume_absorption)
        raise ValueError(
            f"{what}, which only the separable kernel supports, but the run "
            "did not dispatch there"
            + (" (use_pallas='off')" if not sep else
               "; failing predicates: " + "; ".join(sep)))
    if key is None:
        raise ValueError(
            "the run goes to the wave kernel, which draws from the batch's "
            "threefry key: pass key=core.rng.batch_key(iseed, b)")
    return run_wave_kernel(domain, surface, source, key, config,
                           intensity_config, intensity_dirs, n_photons,
                           debug_state=debug_state)


def _run_batch_dir_chunked(domain, surface, source, seed, config, icfg,
                           dirs, n_photons, key) -> Tallies:
    """Direction-chunked radiance (port of
    ``integrator._run_batch_dir_chunked``): split a grid of more than
    ``MAX_KERNEL_DIRS`` directions into kernel-sized passes over the SAME
    photons (same seed, so the same paths). Fluxes are identical across
    chunks and chunk 0's are kept; the images are concatenated, and
    ``n_bad`` adds every later chunk's cut marches to chunk 0's. Directions
    of different chunks share roulette sites, a correlation of the same
    order as the path sharing all directions already have. Only a kernel's
    radiance is chunked: the wave kernel takes any number of directions in
    one pass."""
    max_dirs = le.MAX_KERNEL_DIRS
    parts = []
    for lo in range(0, icfg.n_dirs, max_dirs):
        hi = min(icfg.n_dirs, lo + max_dirs)
        parts.append(run_batch(domain, surface, source, seed, config,
                               n_photons,
                               dataclasses.replace(icfg, n_dirs=hi - lo),
                               dirs[:, lo:hi], key=key))
    n_cut_later = sum(t.n_cut for t in parts[1:])
    return dataclasses.replace(
        parts[0], intensity=torch.cat([t.intensity for t in parts], dim=-1),
        n_bad=parts[0].n_bad + n_cut_later,
        n_cut=parts[0].n_cut + n_cut_later)


# ---------------------------------------------------------------------------
# The XLA wave kernel (integrator.py:556-1036 of the JAX package)

_W_TINY = float(np.float32(1e-30))  # photon-weight cutoff
_BIG = float(np.float32(3e38))
# Batches run on the wave kernel in this process (the hand-written kernels
# count their launches in their own modules).
WAVE_BATCHES = 0


def make_direction_cosines(mu, phi):
    """(mu, phi) -> unit direction cosines (reference:
    Integrators/monteCarloRadiativeTransfer.f95:1876-1894)."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
    return sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), mu


def sample_scattering_cos(inverse_flat, n_steps: int, row, u):
    """Scattering cosine by linear interpolation of the inverse CDF table
    (reference: computeScatteringAngle,
    Integrators/monteCarloRadiativeTransfer.f95:1594-1621)."""
    t = u * float(n_steps - 1)
    k = torch.clamp(t.long(), 0, n_steps - 2)
    frac = t - k.to(torch.float32)
    base = row * n_steps + k
    return torch.cos((1.0 - frac) * inverse_flat[base]
                     + frac * inverse_flat[base + 1])


def run_wave_kernel(domain: OpticalDomain, surface: Surface,
                    source: illumination.Source, key: tuple,
                    config: KernelConfig,
                    intensity_config: Optional[le.IntensityConfig] = None,
                    intensity_dirs: Optional[torch.Tensor] = None,
                    n_photons: Optional[int] = None,
                    debug_state: bool = False):
    """One batch on the wave kernel (the JAX package's ``_run_batch_impl``
    past its Pallas dispatch): ``config.n_lanes`` lanes, each running its
    quota of photons one after another, a lane refilled from the source
    the step after its photon ends. Every draw is
    ``uniform(step_key(key, step, purpose), n)`` over the wave's ``n``
    lanes. Once every quota is spent and at most
    ``max(n_lanes // 16, 2048)`` photons live (``tail_compaction``, waves of
    16,384 lanes or more), the survivors move, in lane order, into a wave
    of that size, whose draws index the compacted lanes; survivors past
    that size at the step cap are dropped and counted in ``n_bad``.
    Returns ``Tallies`` (or, with ``debug_state``, the final lane state)."""
    global WAVE_BATCHES
    if (intensity_config is not None
            and domain.tables.forward_orig.shape[1] == 1
            and not domain.all_hg):
        # without tabulated forward phase functions the estimator would
        # read a zeros placeholder (integrator.py:286-297)
        raise ValueError(
            "intensity requested but the domain has no forward phase "
            "tables; build the domain with compute_intensity_tables=True")
    cfg = config
    grid = domain.grid
    dev = grid.device
    f32 = torch.float32
    nx, ny, nz = grid.shape
    nxy, nxyz = nx * ny, nx * ny * nz
    ncomp = domain.n_components
    N = cfg.n_lanes
    records = domain.cell_records
    inv_flat = domain.tables.inverse.reshape(-1)
    n_cdf_steps = domain.tables.inverse.shape[1]
    offsets = domain.tables.offsets.to(torch.int64)
    beta_max = torch.clamp(torch.max(domain.total_ext), min=_W_TINY)
    inv_beta_max = 1.0 / beta_max
    x0, x_max = grid.x0, grid.x_max
    y0, y_max = grid.y0, grid.y_max
    z0, z_max = grid.z0, grid.z_max
    z_eps = (z_max - z0) * float(np.float32(1e-6))
    icfg = intensity_config
    compute_intensity = icfg is not None
    n_dirs = icfg.n_dirs if compute_intensity else 0
    dirs = intensity_dirs.to(dev) if compute_intensity else None
    limit = compute_intensity and icfg.limit_contributions
    rr_w = float(np.float32(cfg.russian_roulette_weight))
    n_orders = cfg.record_scattering_orders
    uniform_lambertian = surface.is_uniform_lambertian
    refl_uniform = float(surface.params[0, 0, 0])
    # the BRDF's parameter grid on the lanes' device, copied once a batch
    surface = dataclasses.replace(
        surface, params=torch.as_tensor(surface.params, device=dev))

    if n_photons is None:
        quota = torch.full((N,), cfg.photons_per_lane, dtype=torch.int64,
                           device=dev)
    else:
        n_ph = min(int(n_photons), cfg.photons_per_batch)
        lane = torch.arange(N, device=dev)
        quota = n_ph // N + (lane < n_ph % N).long()

    use_macro = domain.macro_factor > 0 and not cfg.use_ray_tracing
    if use_macro:
        mf = domain.macro_factor
        bx_w = (grid.x_edges[1] - grid.x_edges[0]) * mf
        by_w = (grid.y_edges[1] - grid.y_edges[0]) * mf
        bz_w = (grid.z_edges[1] - grid.z_edges[0]) * mf
        clip_nudge = float(np.float32(1e-5)) * torch.minimum(
            bx_w, torch.minimum(by_w, bz_w))

    zeros = torch.zeros((N,), dtype=f32, device=dev)
    state = dict(x=zeros, y=zeros, z=zeros, ux=zeros, uy=zeros,
                 uz=torch.ones_like(zeros), w=zeros,
                 alive=torch.zeros((N,), dtype=torch.bool, device=dev),
                 quota=quota, order=torch.zeros_like(quota),
                 beta_loc=beta_max.expand(N).clone())
    # one tally buffer [up | down | absorption]: a lane adds at most one
    # value a step to it (an exit or the absorption of a real collision)
    flux = torch.zeros((2 * nxy + nxyz,), dtype=f32, device=dev)
    tally_add = make_accumulator()
    scat = (torch.zeros((2 * (n_orders + 1) * nxy,), dtype=f32, device=dev)
            if n_orders > 0 else None)
    intensity = torch.zeros((max(n_dirs, 1) * nxy,), dtype=f32, device=dev)
    ibc = excess = None
    if limit:
        ibc = torch.zeros(((ncomp + 1) * n_dirs * nxy,), dtype=f32,
                          device=dev)
        excess = torch.zeros((n_dirs, ncomp + 1), dtype=f32, device=dev)
    # photons started, bad photons, live lane-steps
    counts = torch.zeros(3, dtype=torch.int64, device=dev)

    def le_add(**kw):
        le.accumulate_local_estimate(
            intensity, domain, dirs, icfg, by_component=ibc, excess=excess,
            **kw)

    def body(st: dict, step: int) -> dict:
        x, y, z = st["x"], st["y"], st["z"]
        ux, uy, uz = st["ux"], st["uy"], st["uz"]
        w, alive, quota = st["w"], st["alive"], st["quota"]
        order, beta_loc = st["order"], st["beta_loc"]
        n = x.shape[0]

        def k(purpose):
            return rng.step_key(key, step, purpose)

        # ---- refill dead lanes from the source ----
        need = ~alive & (quota > 0)
        xf, yf, zf, mu_s, phi_s = illumination.sample(source, k(rng.SOURCE),
                                                      n, dev)
        sx = x0 + xf * (x_max - x0)
        sy = y0 + yf * (y_max - y0)
        sz = torch.minimum(torch.maximum(grid.z_from_fraction(zf),
                                         z0 + z_eps), z_max - z_eps)
        dx_, dy_, dz_ = make_direction_cosines(mu_s, phi_s)
        x, y, z = (torch.where(need, sx, x), torch.where(need, sy, y),
                   torch.where(need, sz, z))
        ux, uy, uz = (torch.where(need, dx_, ux), torch.where(need, dy_, uy),
                      torch.where(need, dz_, uz))
        w = torch.where(need, 1.0, w)
        order = torch.where(need, 0, order)
        beta_loc = torch.where(need, beta_max, beta_loc)
        alive = alive | need
        quota = quota - need.long()
        counts[0] += need.sum()
        counts[2] += alive.sum()

        # LW emission pre-credit: an atmospheric birth takes 1 from the
        # absorption of its cell (reference: :504-508), and with radiance
        # emission contributes at birth (:510-542, 1688-1696)
        if cfg.lw_mode:
            atm_emit = need & (zf > 0)
            ecol = grid.locate_x(x) * ny + grid.locate_y(y)
            ecell = ecol * nz + grid.locate_z(z)
            tally_add(flux, torch.where(atm_emit, 2 * nxy + ecell, 0),
                      torch.where(atm_emit, -1.0, 0.0))
            if compute_intensity:
                kr = k(rng.INTENSITY_RR)
                le_add(mask=atm_emit, weight=w, x=x, y=y, z=z, ux=ux, uy=uy,
                       uz=uz, cell=ecell, comp=None, kind="emission", key=kr)
                le_add(mask=need & ~atm_emit, weight=w, x=x, y=y, z=z,
                       ux=ux, uy=uy, uz=uz, cell=ecol * nz, comp=None,
                       kind="surface", key=kr)

        # ---- one transport step for every live lane ----
        tau = rng.exponential_deviate(k(rng.TAU), n, dev)
        if cfg.use_ray_tracing:
            # DDA: march until tau is reached or a z boundary (reference:
            # :555-563)
            r = dda.trace(domain, x, y, z, ux, uy, uz, alive, tau_stop=tau,
                          max_crossings=cfg.max_dda_crossings)
            bad = alive & (r["tau"] < 0)
            counts[1] += bad.sum()
            exit_top = alive & r["exit_top"]
            exit_bot = alive & r["exit_bot"]
            collide = alive & r["stopped"] & ~bad
            xe, ye = r["x"], r["y"]
            col_e = r["ix"] * ny + r["iy"]
            xc, yc = r["x"], r["y"]
            zc = torch.minimum(torch.maximum(r["z"], z0), z_max)
            cell = (r["ix"] * ny + r["iy"]) * nz + grid.locate_z(zc)
            rec = records[cell]
            real = collide
            moved = collide
            alive = alive & ~bad
        else:
            # Woodcock: one jump against the majorant and a null test; with
            # a macro majorant the jump uses the carried local ceiling and
            # is clipped at the block's face (faces clamped to the domain)
            if use_macro:
                def face(p, p0, u, bw, span):
                    t = (torch.clamp((torch.floor((p - p0) / bw)
                                      + (u >= 0).to(f32)) * bw, 0.0, None)
                         .minimum(span) + p0 - p)
                    return torch.where(u.abs() > 1e-12,
                                  t / torch.where(u == 0, 1.0, u), _BIG)
                tx = face(x, x0, ux, bx_w, x_max - x0)
                ty = face(y, y0, uy, by_w, y_max - y0)
                tz = face(z, z0, uz, bz_w, z_max - z0)
                t_raw = torch.minimum(tx, torch.minimum(ty, tz))
                # on a face heading out: one global-majorant step instead
                escape = t_raw <= 0.0
                beta_loc = torch.where(escape, beta_max, beta_loc)
                d_samp = torch.where(beta_loc > 0, tau / beta_loc, _BIG)
                t_clip = torch.where(escape, _BIG, t_raw + clip_nudge)
                clipped = t_clip < d_samp
                d = torch.minimum(d_samp, t_clip)
            else:
                d = tau * inv_beta_max
                clipped = torch.zeros_like(alive)
            zn = z + uz * d
            exit_top = alive & (zn >= z_max)
            exit_bot = alive & ~exit_top & (zn <= z0)
            collide = alive & ~exit_top & ~exit_bot & ~clipped
            moved = alive & ~exit_top & ~exit_bot
            # the crossing point of an exiting photon (reference:
            # :578-585, 624-631)
            z_b = torch.where(exit_top, z_max, z0)
            safe_uz = torch.where(uz.abs() < 1e-12, 1.0, uz)
            t_b = (z_b - z) / safe_uz
            xe = grid.wrap_x(x + ux * t_b)
            ye = grid.wrap_y(y + uy * t_b)
            col_e = grid.locate_x(xe) * ny + grid.locate_y(ye)
            xc = grid.wrap_x(x + ux * d)
            yc = grid.wrap_y(y + uy * d)
            zc = torch.minimum(torch.maximum(zn, z0), z_max)
            cell = ((grid.locate_x(xc) * ny + grid.locate_y(yc)) * nz
                    + grid.locate_z(zc))
            rec = records[cell]
            u_col = rng.uniform(k(rng.COLLISION), n, dev)
            ceiling = beta_loc if use_macro else beta_max
            real = collide & (u_col * ceiling < rec[:, 0])
            if use_macro:
                beta_loc = torch.where(moved, rec[:, 1], beta_loc)

        # ---- component choice and absorption at real collisions ----
        if ncomp == 1:
            comp = torch.zeros_like(cell)
            ssa_c, pfi_c, g_c = rec[:, 3], rec[:, 4].long(), rec[:, 5]
        else:
            u_comp = rng.uniform(k(rng.COMPONENT), n, dev)
            comp = (rec[:, 2:2 + ncomp] < u_comp[:, None]).sum(dim=1)
            comp = torch.clamp(comp, 0, ncomp - 1)
            pick = comp[:, None]
            ssa_c = rec[:, 2 + ncomp:2 + 2 * ncomp].gather(1, pick)[:, 0]
            pfi_c = rec[:, 2 + 2 * ncomp:2 + 3 * ncomp].gather(
                1, pick)[:, 0].long()
            g_c = rec[:, 2 + 3 * ncomp:2 + 4 * ncomp].gather(1, pick)[:, 0]
        absorbed = torch.where(real, w * (1.0 - ssa_c), 0.0)
        w = torch.where(real, w * ssa_c, w)
        order = torch.where(real, order + 1, order)

        # ---- local estimate at the scattering event (reference:
        # :776-790), with the post-absorption weight ----
        if compute_intensity:
            le_add(mask=real, weight=w, x=xc, y=yc, z=zc, ux=ux, uy=uy,
                   uz=uz, cell=cell, comp=comp, kind="scatter",
                   key=k(rng.INTENSITY_RR), order=order)

        # ---- Russian roulette ----
        if cfg.use_russian_roulette:
            u_rr = rng.uniform(k(rng.ROULETTE), n, dev)
            play = real & (w < 0.5 * rr_w)
            w = torch.where(play, torch.where(u_rr < w / rr_w, rr_w, 0.0), w)
        died_weight = real & (w <= _W_TINY)

        # ---- scattering: a new direction ----
        scatter = real & ~died_weight
        u_ang = rng.uniform(k(rng.SCAT_ANGLE), n, dev)
        if domain.all_hg:
            cos_theta = sample_hg_cos(g_c, u_ang)
        else:
            cos_theta = sample_scattering_cos(inv_flat, n_cdf_steps,
                                              offsets[comp] + pfi_c, u_ang)
        phi_rot = rng.uniform(k(rng.SCAT_AZIMUTH), n, dev, 0.0, 2.0 * np.pi)
        rux, ruy, ruz = rotate_direction(ux, uy, uz, cos_theta, phi_rot)
        ux = torch.where(scatter, rux, ux)
        uy = torch.where(scatter, ruy, uy)
        uz = torch.where(scatter, ruz, uz)

        # ---- surface reflection: the down flux takes the pre-reflection
        # weight, then mu = sqrt(u) and the reflectance (reference:
        # :619-702); a lane reflects or scatters in a step, never both, so
        # the bounce reuses the scattering draws ----
        w_down = w
        mu_new = torch.sqrt(torch.clamp(u_ang, min=1e-12))
        phi_new = phi_rot
        if uniform_lambertian:
            w_refl = w_down * refl_uniform
        else:
            w_refl = w_down * surface.reflectance(
                (xe - x0) / (x_max - x0), (ye - y0) / (y_max - y0), uz,
                mu_new, torch.atan2(uy, ux), phi_new)
        died_surface = exit_bot & (w_refl <= _W_TINY)
        reflected = exit_bot & ~died_surface
        sux, suy, suz = make_direction_cosines(mu_new, phi_new)
        x = torch.where(exit_bot, xe, torch.where(moved, xc, x))
        y = torch.where(exit_bot, ye, torch.where(moved, yc, y))
        z = torch.where(exit_bot, z0 + z_eps, torch.where(moved, zc, z))
        if use_macro:
            beta_loc = torch.where(exit_bot, beta_max, beta_loc)
        in_dir = (ux, uy, uz)
        ux = torch.where(reflected, sux, ux)
        uy = torch.where(reflected, suy, uy)
        uz = torch.where(reflected, suz, uz)
        w = torch.where(reflected, w_refl, w)
        if compute_intensity:
            le_add(mask=reflected, weight=w, x=x, y=y, z=z, ux=ux, uy=uy,
                   uz=uz, cell=col_e * nz, comp=None, kind="surface",
                   key=k(rng.INTENSITY_RR), surface=surface, in_dir=in_dir,
                   weight_pre=w_down)
        alive = alive & ~exit_top & ~died_weight & ~died_surface

        # ---- the fused tally: up | down | absorption, one a lane ----
        f_idx = torch.where(exit_top, col_e, torch.where(
            exit_bot, nxy + col_e, torch.where(real, 2 * nxy + cell, 0)))
        f_val = torch.where(exit_top, w, torch.where(exit_bot, w_down,
                                           torch.where(real, absorbed, 0.0)))
        tally_add(flux, f_idx, f_val)
        if n_orders > 0:
            # exit lanes have not scattered this step: ``order`` is the
            # order at the tally, the bounce increments afterwards
            ob = torch.clamp(order, max=n_orders)
            s_idx = torch.where(exit_top, ob * nxy + col_e, torch.where(
                exit_bot, (n_orders + 1 + ob) * nxy + col_e, 0))
            s_val = torch.where(exit_top, w,
                                torch.where(exit_bot, w_down, 0.0))
            tally_add(scat, s_idx, s_val)
        order = torch.where(reflected, order + 1, order)
        return dict(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, w=w, alive=alive,
                    quota=quota, order=order, beta_loc=beta_loc)

    # ---- two phases: the full wave until every quota is spent and at
    # most n_tail photons live, then those in a wave of n_tail lanes ----
    step = 0
    n_tail = max(N // 16, 2048)
    if cfg.tail_compaction and N >= 16384:
        while step < cfg.max_steps:
            alive_n, has_quota = torch.stack(
                [state["alive"].sum(), (state["quota"] > 0).any().long()]
            ).tolist()
            if not (has_quota or alive_n > 0) or (not has_quota
                                                  and alive_n <= n_tail):
                break
            state = body(state, step)
            step += 1
        alive_n = int(state["alive"].sum())
        sel = torch.nonzero(state["alive"])[:n_tail, 0]
        sel = torch.cat([sel, sel.new_zeros(n_tail - sel.shape[0])])
        valid = torch.arange(n_tail, device=dev) < alive_n
        state = {k2: v[sel] for k2, v in state.items()}
        state["alive"] = state["alive"] & valid
        state["quota"] = torch.zeros_like(state["quota"])
        counts[1] += max(alive_n - n_tail, 0)
    while step < cfg.max_steps and bool(
            (state["alive"] | (state["quota"] > 0)).any()):
        state = body(state, step)
        step += 1

    WAVE_BATCHES += 1
    if debug_state:
        return state
    if limit:
        # capped excess spread across the image (reference: :294-322)
        intensity = le.redistribute_excess(
            intensity.reshape(n_dirs, nxy),
            ibc.reshape(ncomp + 1, n_dirs, nxy), excess).reshape(-1)
    n_started, n_bad, lane_steps = counts.tolist()
    n_bad += int(state["alive"].sum())
    up_by_order = down_by_order = None
    if n_orders > 0:
        by_order = scat.reshape(2, n_orders + 1, nx, ny)
        up_by_order = by_order[0].permute(1, 2, 0)
        down_by_order = by_order[1].permute(1, 2, 0)
    vol = flux[2 * nxy:].reshape(nx, ny, nz)
    return Tallies(
        flux_up=flux[:nxy].reshape(nx, ny),
        flux_down=flux[nxy:2 * nxy].reshape(nx, ny),
        flux_absorbed=vol.sum(dim=2), volume_absorption=vol,
        intensity=(intensity.reshape(n_dirs, nx, ny).permute(1, 2, 0)
                   if compute_intensity else None),
        flux_up_by_order=up_by_order, flux_down_by_order=down_by_order,
        n_photons=n_started, n_bad=n_bad, n_steps=step,
        n_lane_steps=lane_steps)


class Integrator:
    """Convenience wrapper: holds (domain, surface, config) and runs batches
    (the role of the reference's ``integrator`` object and its
    computeRadiativeTransfer; reference:
    Integrators/monteCarloRadiativeTransfer.f95:121-123)."""

    def __init__(self, domain: OpticalDomain, surface: Surface,
                 config: KernelConfig = KernelConfig(),
                 intensity_config: Optional[le.IntensityConfig] = None,
                 intensity_dirs: Optional[torch.Tensor] = None):
        self.domain = domain
        self.surface = surface
        self.config = config
        self.intensity_config = intensity_config
        self.intensity_dirs = intensity_dirs

    def compute(self, source: illumination.Source, seed: int,
                batch_index: int = 0, normalize: bool = True) -> Tallies:
        """Run batch ``batch_index`` of a run seeded with ``seed`` and
        (optionally) normalize per column."""
        t = run_batch(self.domain, self.surface, source,
                      rng.batch_seed(seed, batch_index), self.config,
                      intensity_config=self.intensity_config,
                      intensity_dirs=self.intensity_dirs,
                      key=rng.batch_key(seed, batch_index))
        return t.normalized(self.domain.grid) if normalize else t
