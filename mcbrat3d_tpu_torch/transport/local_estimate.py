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

from mcbrat3d_tpu_torch.core.device import resolve

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
