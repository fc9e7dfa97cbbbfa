"""Local estimation of top-of-domain radiances: configuration and host-side
helpers.

PyTorch counterpart of the host parts of
``mcbrat3d_tpu.transport.local_estimate`` (reference:
Integrators/monteCarloRadiativeTransfer.f95:1623-1832). At every scattering
or surface-reflection event, each radiance direction d receives

    contribution = w * Pn(theta_d) * exp(-tau_d)

where Pn is P/(4 pi mu_d) for a scatter and 1/pi for a Lambertian
reflection, and tau_d is the optical depth from the event to the top of the
domain along d; the contribution is tallied at the column where the ray
leaves the top. The estimator runs in the record and column kernels'
walk kernels (``transport.record_kernel``, ``transport.col_kernel``): the
transport kernel queues its events (``EventQueue``) and the walk kernel
computes every (event, direction) pair. This module holds what the host
decides before a launch: the knobs, the direction cosines, the march
bounds, the event queue and the post-batch redistribution of capped excess.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.core.device import resolve
from mcbrat3d_tpu_torch.transport import dda

# Directions per kernel pass. The per-direction Iwabuchi roulette draws use
# sites 16 + 2d and 17 + 2d of the counter uniform, whose step stride is 256
# sites (core.rng.N_SITES), so 64 directions keep every site below 144 and
# no direction aliases the next step's transport draws. Larger grids (the
# reference goes to 648, Drivers/monteCarloDriver.f95:61) run as chunked
# transport passes over the same photons (integrator.run_batch).
MAX_KERNEL_DIRS = 64
# Default floor of the radiance directions' mu (IntensityConfig.pallas_min_mu,
# the JAX package's default): the in-kernel marches are sized from it.
MIN_MU = 0.15


@dataclasses.dataclass(frozen=True)
class IntensityConfig:
    """Static knobs for radiance computation (subset of the reference's
    ``algorithms`` namelist; reference: Drivers/monteCarloDriver.f95:110-118)."""

    n_dirs: int
    use_russian_roulette: bool = True
    zeta_min: float = 0.3  # Iwabuchi zetaMin
    use_hybrid_phase: bool = True
    n_orders_orig_phase: int = 0  # original phase funcs for the first k orders
    # Contribution capping: spikes are clipped at max_contribution and the
    # clipped excess is redistributed across the image after the batch,
    # proportionally to each (direction, component)'s accumulated intensity
    # (reference: Integrators/monteCarloRadiativeTransfer.f95:1815-1826
    # capping, :294-322 redistribution).
    limit_contributions: bool = False
    max_contribution: float = 77.0
    # Every direction's mu must be >= pallas_min_mu for the in-kernel local
    # estimate: the cell march's iteration bound is sized from this floor
    # (dda_iteration_bound), so a shallower direction is refused by name
    # unless the floor is lowered (longer marches).
    pallas_min_mu: float = MIN_MU


def make_intensity_directions(mus, phis_deg, device="cuda") -> torch.Tensor:
    """[3, ndir] float32 unit direction cosines for the radiance detectors.

    mus > 0 look up through the top of the domain (the reference requires
    nonzero mu; reference: Drivers/monteCarloDriver.f95:242-277).
    """
    mus = np.asarray(mus, np.float64).ravel()
    phis = np.deg2rad(np.asarray(phis_deg, np.float64).ravel())
    if mus.shape != phis.shape:
        raise ValueError("mus and phis must have equal length")
    if np.any(mus == 0.0):
        raise ValueError("radiance directions must have nonzero mu")
    sin_t = np.sqrt(1.0 - mus**2)
    dirs = np.stack([sin_t * np.cos(phis), sin_t * np.sin(phis), mus])
    return torch.tensor(dirs.astype(np.float32), device=resolve(device))


def dirs_mu_floor_ok(icfg: IntensityConfig, dirs: torch.Tensor) -> bool:
    """Every direction's mu is at or above the floor
    ``icfg.pallas_min_mu`` (port of ``pallas_kernel.dirs_mu_floor_ok``)."""
    return bool(torch.all(dirs[2] >= max(icfg.pallas_min_mu, 1e-6)))


def dda_iteration_bound(grid, min_mu: float) -> int:
    """Bound on the cell-face crossings of one march from the domain
    bottom to the top along the shallowest admissible direction
    (mu >= min_mu), plus margin (``pallas_kernel.dda_iteration_bound``)."""
    nx, ny, nz = grid.shape
    xe, ye, ze = grid.edges_np()
    lz, dxc, dyc = ze[-1] - ze[0], (xe[-1] - xe[0]) / nx, (ye[-1] - ye[0]) / ny
    mu = max(min_mu, 1e-3)
    sin_max = float(np.sqrt(max(0.0, 1.0 - mu * mu)))
    return int(np.ceil(nz + lz / mu * sin_max / min(dxc, dyc))) + 8


def march_bound(grid, dirs: torch.Tensor, min_mu: float) -> int:
    """Iteration bound of a launch's marches: the larger of
    ``dda_iteration_bound`` and the crossings each concrete direction can
    make (``pallas_kernel.march_bound_for_dir``, cell march), so a
    diagonal direction near the mu floor, which crosses x and y faces
    both, is never cut short where the JAX kernel would march on."""
    nx, ny, nz = grid.shape
    xe, ye, ze = grid.edges_np()
    lz, dxc, dyc = ze[-1] - ze[0], (xe[-1] - xe[0]) / nx, (ye[-1] - ye[0]) / ny
    bound = dda_iteration_bound(grid, min_mu)
    for ux, uy, uz in dirs.double().cpu().T.tolist():
        uzf = max(uz, 1e-3)
        bound = max(bound, nz + int(np.ceil(lz * abs(ux) / uzf / dxc)) + 1
                    + int(np.ceil(lz * abs(uy) / uzf / dyc)) + 1 + 6)
    return bound


@dataclasses.dataclass(frozen=True)
class EventQueue:
    """The local-estimate events of a transport launch, struct of arrays
    as the kernels write them (``csrc/*_kernel.cu`` ``Queue``): ``f``
    float32 [n_f, capacity] and ``i`` int32 [n_i, capacity], one record a
    column, and ``ctl`` int32 [2]: the events the last launch queued (each
    queueing counts, so a fill past the capacity shows events not stored)
    and the most any launch queued since the queue was made. Made once per
    batch and reused by every launch of its relaunch loop."""

    f: torch.Tensor
    i: torch.Tensor
    ctl: torch.Tensor

    @staticmethod
    def empty(n_f: int, n_i: int, capacity: int, device) -> "EventQueue":
        return EventQueue(
            f=torch.empty((n_f, capacity), dtype=torch.float32,
                          device=device),
            i=torch.empty((n_i, capacity), dtype=torch.int32, device=device),
            ctl=torch.zeros(2, dtype=torch.int32, device=device))

    @property
    def capacity(self) -> int:
        return self.f.shape[1]

    def check(self) -> int:
        """The most events a launch queued; raises if that is past the
        capacity (a host read of the device counter)."""
        peak = int(self.ctl[1])
        if peak > self.capacity:
            raise RuntimeError(
                f"a launch queued {peak} local-estimate events into a queue "
                f"of {self.capacity}; {peak - self.capacity} were not "
                "estimated")
        return peak

    def queued(self) -> tuple:
        """(f, i) of the events the last launch queued, [n_f, n] and
        [n_i, n] views (a host read of the fill); raises past the
        capacity."""
        n = int(self.ctl[0])
        if n > self.capacity:
            raise RuntimeError(f"the last launch queued {n} events into a "
                               f"queue of {self.capacity}")
        return self.f[:, :n], self.i[:, :n]


def check_queue(queue: EventQueue | None, n_f: int, n_i: int, need: int,
                device) -> None:
    """Raise unless ``queue`` is an event queue on ``device`` with ``n_f``
    float and ``n_i`` int rows that holds ``need`` records (a launch's lanes
    times its steps), as the column and record kernels write it."""
    if queue is None:
        raise ValueError("a radiance launch needs the tally's event queue "
                         "(the tally's zeros(..., queue_capacity=...))")
    if queue.capacity < need:
        raise ValueError(f"event queue of {queue.capacity} records for a "
                         f"launch that may queue {need}")
    for name, t, dtype, shape in (
            ("queue.f", queue.f, torch.float32, (n_f, queue.capacity)),
            ("queue.i", queue.i, torch.int32, (n_i, queue.capacity)),
            ("queue.ctl", queue.ctl, torch.int32, (2,))):
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def redistribute_excess(intensity: torch.Tensor, by_component: torch.Tensor,
                        excess: torch.Tensor) -> torch.Tensor:
    """Spread capped excess across the image, proportionally to each
    (direction, component)'s accumulated intensity pattern (reference:
    Integrators/monteCarloRadiativeTransfer.f95:294-322).

    ``intensity`` [n_dirs, nxy], ``by_component`` [ncomp+1, n_dirs, nxy]
    (slot 0 = surface), ``excess`` [n_dirs, ncomp+1]."""
    sums = by_component.sum(dim=2)
    weightings = by_component / torch.clamp(sums[:, :, None], min=1e-30)
    return intensity + torch.einsum("cdp,dc->dp", weightings, excess)


_F32_PI = float(np.float32(np.pi))
_F32_INV_PI = float(np.float32(1.0 / np.pi))
_F32_4PI = float(np.float32(4.0 * np.pi))


def _phase_value(domain, cell, comp, cos_scat, orig: bool):
    """The tabulated (hybrid or original) forward phase function at the
    event's scattering cosine, linear in angle (reference:
    lookUpPhaseFuncValsFromTable,
    Integrators/monteCarloRadiativeTransfer.f95:1834-1873); an all-HG
    domain without tables evaluates HG from the cell record's g."""
    table = domain.tables.forward_orig if orig else domain.tables.forward
    n_angles = table.shape[1]
    nc = domain.n_components
    if n_angles == 1 and domain.all_hg:
        g = domain.cell_records[cell, 2 + 3 * nc + comp]
        c = torch.clamp(cos_scat, -1.0, 1.0)
        return (1.0 - g * g) * ((1.0 + g * g) - (2.0 * g) * c) ** -1.5
    flat = table.reshape(-1)
    pfi = domain.phase_index.reshape(-1)[cell * nc + comp].long()
    row = domain.tables.offsets.long()[comp] + pfi
    theta = torch.arccos(torch.clamp(cos_scat, -1.0, 1.0))
    t = theta * float(np.float32((n_angles - 1) / np.pi))
    k = torch.clamp(t.long(), 0, n_angles - 2)
    frac = t - k.to(torch.float32)
    base = row * n_angles + k
    return (1.0 - frac) * flat[base] + frac * flat[base + 1]


def accumulate_local_estimate(intensity, domain, dirs, icfg: IntensityConfig,
                              mask, weight, x, y, z, ux, uy, uz, cell, comp,
                              kind: str, key: tuple, by_component=None,
                              excess=None, order=None, surface=None,
                              in_dir=None, weight_pre=None) -> None:
    """Add one wave's event contributions to the flat image ``intensity``
    [n_dirs * nx * ny] in place (port of
    ``local_estimate.accumulate_local_estimate``).

    ``kind``: 'scatter' (phase value P / (4 pi |mu_d|); ``comp`` the
    scattering component), 'surface' (1/pi, or with a non-Lambertian
    ``surface`` its BRDF toward each direction, Rf(in -> d) / pi, times
    the pre-reflection ``weight_pre``, ``in_dir`` the incoming direction)
    or 'emission' (1 / (4 pi |mu_d|)). Each direction's transmittance is a
    ``dda.trace`` march; with ``icfg.use_russian_roulette`` the Iwabuchi
    roulette (reference:
    Integrators/monteCarloRadiativeTransfer.f95:1753-1813) draws
    ``uniform(fold_in(key, d))`` and the free path on
    ``fold_in(fold_in(key, d), 1)``. With ``icfg.limit_contributions``
    ``by_component`` [(ncomp+1) * n_dirs * nx * ny] (slot 0 the surface and
    emission) and ``excess`` [n_dirs, ncomp+1] take the capped excess
    (reference: :1815-1826)."""
    grid = domain.grid
    nx, ny, _ = grid.shape
    nxy = nx * ny
    n_dirs = icfg.n_dirs
    limit = icfg.limit_contributions
    dev = x.device
    comp_slot = comp + 1 if kind == "scatter" else torch.zeros_like(cell)
    zeta = float(np.float32(icfg.zeta_min))
    brdf = (kind == "surface" and surface is not None
            and not surface.is_uniform_lambertian)
    if brdf:
        xfrac = (x - grid.x0) / (grid.x_max - grid.x0)
        yfrac = (y - grid.y0) / (grid.y_max - grid.y0)
        phi_in = torch.atan2(in_dir[1], in_dir[0])
    for d in range(n_dirs):
        dx, dy, dz = dirs[0, d], dirs[1, d], dirs[2, d]
        mu_abs = dz.abs()
        wgt = weight
        if kind == "surface":
            if brdf:
                phi_out = torch.atan2(dy, dx).expand_as(x)
                rf = surface.reflectance(xfrac, yfrac, in_dir[2],
                                         mu_abs.expand_as(x), phi_in, phi_out)
                npf = rf * _F32_INV_PI
                wgt = weight_pre
            else:
                npf = torch.full_like(weight, _F32_INV_PI)
        elif kind == "emission":
            npf = (1.0 / (_F32_4PI * mu_abs)) * torch.ones_like(weight)
        else:
            cos_scat = (ux * dx + uy * dy) + uz * dz
            pv = _phase_value(domain, cell, comp, cos_scat,
                              orig=not icfg.use_hybrid_phase)
            if (icfg.use_hybrid_phase and icfg.n_orders_orig_phase > 0
                    and order is not None):
                # the first k orders use the original phase function
                # (reference: :1713-1725)
                pv_orig = _phase_value(domain, cell, comp, cos_scat,
                                       orig=True)
                pv = torch.where(order <= icfg.n_orders_orig_phase,
                                 pv_orig, pv)
            npf = pv / (_F32_4PI * mu_abs)
        ddx, ddy, ddz = dx.expand_as(x), dy.expand_as(x), dz.expand_as(x)
        if not icfg.use_russian_roulette:
            r = dda.trace(domain, x, y, z, ddx, ddy, ddz, mask)
            ok = r["exit_top"] & (r["tau"] >= 0)
            contrib = torch.where(ok, (wgt * npf) * torch.exp(-r["tau"]),
                                  0.0)
            col = r["ix"] * ny + r["iy"]
        else:
            # Iwabuchi 2006 Eqs 13-14: a small contribution marches to the
            # free path and is accepted with probability npf pi / zeta; a
            # large one marches to tau_max = -log(zeta / (npf pi)) and, if
            # still inside, continues by roulette to the free path
            kk = rng.fold_in(key, d)
            n = x.shape[0]
            u1 = rng.uniform(kk, n, dev)
            tau_free = rng.exponential_deviate(rng.fold_in(kk, 1), n, dev)
            npf_pi = _F32_PI * npf
            small = npf_pi <= zeta
            tau_max = -rng.xla_log(zeta / torch.clamp(npf_pi, min=1e-30))
            tau_cap = torch.where(small, tau_free, tau_max)
            r = dda.trace(domain, x, y, z, ddx, ddy, ddz, mask,
                          tau_stop=tau_cap)
            escaped = r["exit_top"] & (r["tau"] >= 0)
            contrib_a = torch.where(escaped & (u1 <= npf_pi / zeta),
                                    (wgt * zeta) / _F32_PI, 0.0)
            contrib_b = torch.where(
                escaped, (wgt * npf) * torch.exp(-r["tau"]), 0.0)
            cont = mask & ~small & r["stopped"]
            r2 = dda.trace(domain, r["x"], r["y"], r["z"], ddx, ddy, ddz,
                           cont, tau_stop=tau_free)
            contrib_rr = torch.where(cont & r2["exit_top"],
                                     (wgt * zeta) / _F32_PI, 0.0)
            contrib = torch.where(small, contrib_a, contrib_b + contrib_rr)
            col = torch.where(cont, r2["ix"] * ny + r2["iy"],
                              r["ix"] * ny + r["iy"])
        if limit:
            cap = float(np.float32(icfg.max_contribution))
            over = torch.where(mask, torch.clamp(contrib - cap, min=0.0), 0.0)
            contrib = torch.clamp(contrib, max=cap)
            excess[d].index_add_(0, torch.where(mask, comp_slot, 0).long(),
                                 over)
        hit = mask & (contrib > 0)
        val = torch.where(mask, contrib, 0.0)
        intensity.index_add_(0, torch.where(hit, d * nxy + col, 0), val)
        if limit:
            by_component.index_add_(
                0, torch.where(hit, (comp_slot * n_dirs + d) * nxy + col, 0),
                val)

