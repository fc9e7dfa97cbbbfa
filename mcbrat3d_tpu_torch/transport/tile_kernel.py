"""Tiled dense-domain kernel (K5): the CUDA kernel, its plain PyTorch pass
and the pass loop around them.

PyTorch counterpart of ``mcbrat3d_tpu.transport.pallas_tile``
(``plan_tiles``, ``tile_ineligibility_reasons``, ``tile_fields``,
``_pack_tile_table``, ``_build_tile_kernel``, ``_make_tile_launch``,
``run_batch_pallas_tile``, ``run_batch_pallas_tile_tallies``) for dense,
full-rank 3D extinction fields past every template: the BASELINE.md
"MODIS-retrieved 3D domain" class, which the reference covers with its
replicated-domain model (src/opticalProperties.f95:77-115).

The domain is cut into at most 127 tiles of at most 32,768 cells by the
planner, and every tile carries its own Woodcock majorant (the largest
extinction in it). Photons live in a pool of slots. Two schedules drive
the kernel:

The refill schedule (``TileConfig(refill=True)``, what ``run_batch``
runs): ``record_kernel.relaunch_loop``, the host loop of K1-K4, launches
the kernel in its refill mode, ``k_steps`` steps a launch, with a per-slot
photon quota (rebalanced evenly over the slots after each launch). A dead
slot with quota left starts a fresh photon in the kernel (the injection's
draws at the step's counter, keyed by the slot), and a live photon follows
its path into every tile it crosses. One read-back a launch; no sort, no
pack, no cohort padding. Photons still alive at the step cap
(``TileConfig.max_passes`` launches) are counted in ``n_bad``.

The sorted-pass schedule (the JAX package's; ``TileConfig()``): each pass

* injects fresh photons from the source into the lowest-index dead slots
  (at most the pool size live at once, at most the quota in all), at the
  top, in the tile under their entry point;
* sorts the live photons by (tile, slot) and packs them into per-tile
  cohorts padded to multiples of B slots (``TileConfig.rows_b`` x 128), so
  that slot numbers, which key the counter uniforms, are the JAX kernel's;
* runs one kernel pass: each slot takes up to ``k_steps`` steps while its
  photon stays in its tile: a jump against the tile majorant clipped at
  the tile's box, the null-collision test, absorption, roulette and an HG
  or tabulated scatter, or a crossing into the neighbouring tile along the
  crossing axis (periodic in x and y) that also skips up to
  ``skip_iters`` empty tiles, parking at the domain's top and bottom
  tiles, or an exit through the domain top or bottom with Lambertian
  reflection; it tallies flux up, flux down and absorption per column.

The sorted passes stop when the quota is spent and at most pool /
``drain_div`` photons are left alive, or at ``max_passes``. A tail may
follow (``TileConfig.tail_steps``, ``sorted_config``): passes without sort
or pack in which each straggler follows its path across tiles for many
steps. Photons still alive at the end are counted in ``n_bad`` (the tiled
analog of the reference's step cap,
Integrators/monteCarloRadiativeTransfer.f95:562-563).

Two implementations of one launch, in either mode:

* ``csrc/tile_kernel.cu``, one CUDA thread per pool slot (``_launch_cuda``);
* ``tile_pass_plain``, the same launch on ``[n_pad]`` tensors with masked
  ``torch.where`` selects, operation for operation the JAX kernel's float32
  arithmetic without its TPU layout: the per-cell fields are read from
  dense arrays in global cell order (no per-tile slabs, no select chains)
  and the tallies add into global [3, nx, ny] columns (no one-hot
  products).

``tile_pass`` sends CUDA tensors to the kernel and CPU tensors to the plain
pass; there is no fallback between them. Both draw the counter uniforms of
``core.rng`` keyed by the slot at the JAX kernel's sites, so for one seed
and one injection they follow the JAX kernel's photon paths (interpret
mode, whose uniforms are the counter mixer). The injection draws its
uniforms from the same counter stream at sites of its own (the JAX package
draws them with threefry): in the sorted schedule at the pass's counter on
the host, where a caller may pass other injection uniforms, as the tests
do with the JAX package's; in the refill mode at the step's counter in the
launch.

Not carried over from the TPU kernel: the ``[*, 128]`` slab layout and its
BlockSpec DMA, the select chains, the one-hot MXU tally, the ``majrow``
lane packing, the grid-length guard (``guard_rows_b``) and the 2^24 packed
sort key; ``n_steps`` counts the lane-steps run with a live photon where
the JAX package reports passes x ``k_steps``; and the tail is the port's
(the JAX package stops at the drain floor).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.domain.domain import (OpticalDomain,
                                              multi_component_records)
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import (Tallies,
                                                     rotate_direction,
                                                     sample_hg_cos)

# Envelope shared with the JAX tiled kernel (pallas_tile.TILE_CELLS_MAX,
# MAX_TILES): the plan fixes the majorant partition and so the paths.
TILE_CELLS_MAX = 256 * 128
MAX_TILES = 127
# Record-eligible domains past this many cells go to the tiled kernel when
# it takes them (the JAX dispatch, integrator.py:455-471).
TILE_MIN_CELLS = 128 * 128
# Shared memory a kernel block may take for the inverse-CDF table (two
# 256-thread blocks per SM); a larger table is read from global memory.
TABLE_SMEM = 96 * 1024
# Steps per tail pass of the sorted schedule (sorted_config): once at most
# pool / 64 photons are alive, the sorted passes cost a sort of the whole
# pool for few steps each (near-horizontal photons above the cloud cross
# thousands of tiles), so the tail lets them follow their paths across
# tiles.
TAIL_STEPS = 1024
# Steps per launch of the refill schedule (run_batch_tile_tallies'
# default), chosen on the card over 128-8192 on the dense headline
# (PERF.md): a batch ends with its longest photon's serial chain of steps,
# so fewer, longer launches win (4096 is within 5% of 8192), and the step
# cap is met to within one launch (20,480 steps for the default 20,000).
REFILL_STEPS = 4096

# Kernel launches made by ``_launch_cuda`` in this process (one per pass
# or refill launch).
TILE_LAUNCHES = 0

# Draw sites of the kernel (pallas_tile.py:474-478, 561), at counter
# pass * k_steps + step, and of the injection (the port's own), at counter
# pass (sorted schedule) or step (refill mode): entry x, entry y, the
# source's azimuth (random azimuth) or mu (flux), the flux source's
# azimuth. The two sets never meet, so a refilled photon moves in its birth
# step.
SITE_TAU, SITE_COLLIDE, SITE_ANGLE, SITE_PHI, SITE_ROULETTE = 3, 4, 5, 6, 7
SITE_COMPONENT = 8
INJECTION_SITES = (0, 1, 2, 9)
# Source kinds of the refill mode, by index (csrc/tile_kernel.cu SRC_*).
SOURCE_KINDS = (illumination.DIRECTIONAL, illumination.RANDOM_AZIMUTH,
                illumination.FLUX, illumination.SPOTLIGHT)

# Slots of the float32 parameter vector (csrc/tile_kernel.cu P_*).
(P_X0, P_LX, P_Y0, P_LY, P_Z0, P_LZ, P_ALBEDO, P_SSA_U, P_G_U, P_RR_W,
 P_HALF_RR, P_INV_DX, P_INV_DY, P_INV_DZ, P_TXP, P_TYP, P_TZP, P_ZMAX,
 P_ZLO, P_ZHI, P_NUDGE, P_TWO_PI, P_SMU, P_SUX, P_SUY, P_SPOT_X, P_SPOT_Y,
 N_PARAMS) = range(28)
# counts: photons started, slots with work left (alive or quota > 0),
# lane-steps run with a live photon, real collisions (relaunch_loop's
# first four); the pass mode adds only the last two.
N_COUNTS = 4

_TINY = rk._TINY
_BIG = 3e38
_F32 = np.float32
_TOP_EPS = _F32(1e-6)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Launch geometry of the tiled kernel (``pallas_tile.TileConfig``
    without its interpret switch) and the schedule: the JAX package's
    sorted passes, or with ``refill`` the relaunch loop over the kernel's
    refill mode (which reads only ``k_steps``, ``skip_iters``,
    ``max_passes`` and ``force_tiles``)."""

    rows_b: int = 16        # cohort padding: B = rows_b * 128 slots
    k_steps: int = 24       # transport steps per slot and pass (launch)
    skip_iters: int = 4     # empty-tile skip chain per crossing
    max_passes: int = 8192  # cap on sort + transport passes (launches)
    # drain floor: once the quota is spent, stop the sorted passes when at
    # most pool / drain_div photons are alive; 0: no floor
    drain_div: int = 64
    # the tail: after the sorted passes, up to tail_passes passes of
    # tail_steps steps in which each photon follows its path across tiles
    # (no sort, no pack); photons still alive then count in n_bad. 0: no
    # tail, the JAX package's behaviour
    tail_steps: int = 0
    tail_passes: int = 0
    # a fixed (tx, ty, tz) plan, so that small domains still cross tiles
    force_tiles: Optional[tuple] = None
    # the refill schedule: slots start photons in the kernel, photons
    # cross tiles, relaunch_loop drives the launches
    refill: bool = False

    @property
    def cohort(self) -> int:
        return self.rows_b * 128


# ---------------------------------------------------------------------------
# Planner and envelope
# ---------------------------------------------------------------------------

_PLAN_CACHE: dict = {}


def plan_for(domain: OpticalDomain) -> Optional[tuple]:
    """The tile plan with the per-cell field count folded into the cell
    cap (n_f * rows <= 1024, pallas_tile.plan_for)."""
    n_f = tile_fields(domain)[0]
    rows_max = max(8, (1024 // max(n_f, 1)) // 8 * 8)
    return plan_tiles(domain.grid,
                      cells_max=min(TILE_CELLS_MAX, rows_max * 128))


def plan_tiles(grid, cells_max: int = TILE_CELLS_MAX) -> Optional[tuple]:
    """(tx, ty, tz): divisors of the grid shape whose tiles hold at most
    ``cells_max`` cells with at most MAX_TILES tiles, minimizing the
    tile-crossing rate per unit path 1/Tx + 1/Ty + 1/Tz in physical units
    (ties: the larger tile). None when no plan exists."""
    nx, ny, nz = grid.shape
    xe, ye, ze = grid.edges_f32()
    dx = float(xe[-1] - xe[0]) / nx
    dy = float(ye[-1] - ye[0]) / ny
    dz = float(ze[-1] - ze[0]) / nz
    ck = (nx, ny, nz, dx, dy, dz, cells_max)
    if ck not in _PLAN_CACHE:
        _PLAN_CACHE[ck] = _plan_tiles_impl(nx, ny, nz, dx, dy, dz, cells_max)
    return _PLAN_CACHE[ck]


def _plan_tiles_impl(nx, ny, nz, dx, dy, dz, cells_max) -> Optional[tuple]:

    def divisors(n):
        return [d for d in range(1, n + 1) if n % d == 0]

    best, best_cost = None, None
    for tx in divisors(nx):
        for ty in divisors(ny):
            for tz in divisors(nz):
                cells = tx * ty * tz
                n_tiles = (nx // tx) * (ny // ty) * (nz // tz)
                if cells > cells_max or n_tiles > MAX_TILES:
                    continue
                cost = (1.0 / (tx * dx) + 1.0 / (ty * dy)
                        + 1.0 / (tz * dz))
                if best_cost is None or cost < best_cost - 1e-12 or (
                        abs(cost - best_cost) <= 1e-12
                        and cells > best[0] * best[1] * best[2]):
                    best, best_cost = (tx, ty, tz), cost
    return best


def tile_fields(domain: OpticalDomain) -> tuple:
    """(n_f, need_ssa, need_f2, ncomp): the per-cell fields a collision
    reads. One component: beta, ssa unless uniform, f2 (the HG g, or the
    stacked inverse-CDF row) unless uniform; two or three: beta, ssa_eff,
    the cumulative scattering fractions cs_0 (, cs_1) and f2 per
    component."""
    ncomp = domain.n_components
    if ncomp == 1:
        need_ssa = not domain.uniform_ssa
        need_f2 = not ((domain.all_hg and domain.uniform_hg)
                       or (not domain.all_hg
                           and domain.tables.inverse.shape[0] == 1))
        return (1 + int(need_ssa) + int(need_f2), need_ssa, need_f2,
                ncomp)
    return 2 + (ncomp - 1) + ncomp, True, True, ncomp


def tile_ineligibility_reasons(domain: OpticalDomain, surface: Surface,
                               source: illumination.Source,
                               lw_mode: bool, compute_intensity: bool,
                               record_scattering_orders: int,
                               use_ray_tracing: bool,
                               need_volume_absorption: bool,
                               need_absorption_profile: bool = False) -> list:
    """Names of every failing tiled-kernel predicate (empty = eligible),
    the names of ``pallas_tile.tile_ineligibility_reasons``."""
    grid = domain.grid
    checks = [
        ("lw_mode", not lw_mode),
        ("compute_intensity", not compute_intensity),
        ("record_scattering_orders", record_scattering_orders == 0),
        ("use_ray_tracing", not use_ray_tracing),
        ("need_volume_absorption", not need_volume_absorption),
        ("need_absorption_profile", not need_absorption_profile),
        ("domain has no per-cell records", domain.cell_records is not None),
        (f"n_components={domain.n_components} > 3",
         domain.n_components <= 3),
        ("non-analytic oversize phase table",
         domain.all_hg or domain.tables.inverse.numel() <= 131072),
        ("emission source", source.kind != illumination.EMISSION),
        ("non-uniform-Lambertian surface", surface.is_uniform_lambertian),
        ("irregular grid", grid.xy_regular and grid.z_regular),
        ("no tile plan", plan_for(domain) is not None),
    ]
    return [name for name, ok in checks if not ok]


def tile_eligible(*args, **kwargs) -> bool:
    return not tile_ineligibility_reasons(*args, **kwargs)


# ---------------------------------------------------------------------------
# Kernel inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileFields:
    """What the kernel reads of a domain under one plan: ``fields``
    [n_f, nx*ny*nz] f32 in global cell order, ``majs`` [n_tiles + 1] the
    tile majorants and a zero DEAD slot, and the stacked inverse-CDF angles
    with their forward differences (one-element placeholders on analytic
    domains)."""

    fields: torch.Tensor
    majs: torch.Tensor
    inv_a0: torch.Tensor
    inv_dd: torch.Tensor

    @staticmethod
    def of(domain: OpticalDomain, tiles: tuple) -> "TileFields":
        """Built once per domain and plan and cached on the domain (the
        values of pallas_tile._pack_tile_table, un-tiled)."""
        cache = domain.__dict__.setdefault("_tile_fields_cache", {})
        if tiles not in cache:
            cache[tiles] = TileFields._build(domain, tiles)
        return cache[tiles]

    @staticmethod
    def _build(domain: OpticalDomain, tiles: tuple) -> "TileFields":
        nx, ny, nz = domain.grid.shape
        tx, ty, tz = tiles
        beta = domain.total_ext.to(torch.float32)
        maj = beta.reshape(nx // tx, tx, ny // ty, ty, nz // tz, tz).amax(
            dim=(1, 3, 5)).reshape(-1)
        majs = torch.cat([maj, maj.new_zeros(1)]).contiguous()
        rec = domain.cell_records
        _, need_ssa, need_f2, ncomp = tile_fields(domain)
        parts = [beta.reshape(-1)]
        if ncomp == 1:
            if need_ssa:
                parts.append(rec[:, 3])
            if need_f2:  # the row of component 0 (its offset is 0)
                parts.append(rec[:, 5] if domain.all_hg else rec[:, 4])
        else:
            # scattering-coefficient formulation (pallas_tile.py:303-324):
            # effective ssa, cumulative scattering fractions and f2 per
            # component, the record kernel's multi-component record
            rec8 = multi_component_records(domain)
            parts += [rec8[:, 2], *rec8[:, 3:2 + ncomp].T,
                      *rec8[:, 5:5 + ncomp].T]
        fields = torch.stack(parts).contiguous()
        zero = torch.zeros(1, dtype=torch.float32, device=beta.device)
        a0, dd = (zero, zero) if domain.all_hg else rk.inverse_table(domain)
        return TileFields(fields=fields, majs=majs, inv_a0=a0, inv_dd=dd)


@dataclasses.dataclass(frozen=True)
class TileParams:
    """Scalars of one batch: ``values`` the float32 parameter vector (P_*
    slots, computed in float32 as the JAX kernel computes them),
    ``device_values`` its copy on the kernel's device, the plan, the field
    layout and the source's injection scalars (float32)."""

    values: np.ndarray
    device_values: torch.Tensor
    shape: tuple
    tiles: tuple
    n_f: int
    need_ssa: bool
    need_f2: bool
    ncomp: int
    analytic_hg: bool
    inv_n_steps: int
    use_rr: bool
    skip_iters: int
    source_kind: str
    smu: np.float32
    sux: np.float32
    suy: np.float32
    spot_x: np.float32
    spot_y: np.float32

    def __getitem__(self, slot: int) -> float:
        return float(self.values[slot])

    @property
    def n_tiles_xyz(self) -> tuple:
        return tuple(n // t for n, t in zip(self.shape, self.tiles))

    @property
    def n_tiles(self) -> int:
        ntx, nty, ntz = self.n_tiles_xyz
        return ntx * nty * ntz

    @property
    def n_acc(self) -> int:
        """Tally entries: [up nxy | down nxy | absorbed nxy]."""
        return 3 * self.shape[0] * self.shape[1]

    @property
    def src(self) -> int:
        """The source kind's index in ``SOURCE_KINDS``."""
        return SOURCE_KINDS.index(self.source_kind)

    @staticmethod
    def make(domain: OpticalDomain, surface: Surface,
             source: illumination.Source, tiles: tuple, tcfg: TileConfig,
             use_russian_roulette: bool,
             russian_roulette_weight: float) -> "TileParams":
        f = _F32
        nx, ny, nz = domain.grid.shape
        tx, ty, tz = tiles
        xe, ye, ze = domain.grid.edges_f32()
        x0, y0, z0 = xe[0], ye[0], ze[0]
        lx, ly, lz = xe[-1] - xe[0], ye[-1] - ye[0], ze[-1] - ze[0]
        dxc, dyc, dzc = lx / f(nx), ly / f(ny), lz / f(nz)
        z_max, z_eps = z0 + lz, lz * _TOP_EPS
        rr_w = f(russian_roulette_weight)
        n_f, need_ssa, need_f2, ncomp = tile_fields(domain)
        rec0 = domain.cell_records[0].cpu().numpy()
        vals = np.zeros(N_PARAMS, np.float32)
        vals[[P_X0, P_LX, P_Y0, P_LY, P_Z0, P_LZ]] = (x0, lx, y0, ly, z0, lz)
        vals[[P_ALBEDO, P_SSA_U, P_G_U, P_RR_W, P_HALF_RR]] = (
            f(surface.albedo), rec0[3] if ncomp == 1 else f(0.0),
            rec0[5] if ncomp == 1 else f(0.0), rr_w, f(0.5) * rr_w)
        vals[[P_INV_DX, P_INV_DY, P_INV_DZ]] = (f(nx) / lx, f(ny) / ly,
                                                f(nz) / lz)
        vals[[P_TXP, P_TYP, P_TZP]] = f(tx) * dxc, f(ty) * dyc, f(tz) * dzc
        vals[[P_ZMAX, P_ZLO, P_ZHI]] = z_max, z0 + z_eps, z_max - z_eps
        vals[[P_NUDGE, P_TWO_PI]] = (f(1e-5) * min(dxc, min(dyc, dzc)),
                                     f(2.0 * np.pi))
        # the injection's scalars (pallas_tile.py:1042-1048): absent
        # fields take the JAX package's defaults
        smu = abs(f(source.solar_mu if source.kind != illumination.FLUX
                    else 1.0))
        sphi = f(source.solar_azimuth)
        sth = np.sqrt(np.maximum(f(0.0), f(1.0) - smu * smu))
        sux, suy = sth * np.cos(sphi), sth * np.sin(sphi)
        spot_x, spot_y = f(source.solar_x), f(source.solar_y)
        vals[[P_SMU, P_SUX, P_SUY, P_SPOT_X, P_SPOT_Y]] = (smu, sux, suy,
                                                          spot_x, spot_y)
        return TileParams(
            values=vals,
            device_values=torch.as_tensor(vals, device=domain.device),
            shape=(nx, ny, nz), tiles=tuple(tiles), n_f=n_f,
            need_ssa=need_ssa, need_f2=need_f2, ncomp=ncomp,
            analytic_hg=bool(domain.all_hg),
            inv_n_steps=int(domain.tables.inverse.shape[1]),
            use_rr=bool(use_russian_roulette), skip_iters=tcfg.skip_iters,
            source_kind=source.kind, smu=smu, sux=sux, suy=suy,
            spot_x=spot_x, spot_y=spot_y)


@dataclasses.dataclass
class TilePool:
    """The photon pool: ``st`` float32 [7, n_pad] (x, y, z, ux, uy, uz, w),
    ``tile`` int32 [n_pad], each slot's tile or n_tiles (DEAD), and for the
    refill mode ``quota`` int32 [n_pad], the photons each slot has yet to
    start."""

    st: torch.Tensor
    tile: torch.Tensor
    quota: Optional[torch.Tensor] = None

    @staticmethod
    def empty(n_pad: int, n_tiles: int, device) -> "TilePool":
        return TilePool(
            st=torch.zeros(7, n_pad, dtype=torch.float32, device=device),
            tile=torch.full((n_pad,), n_tiles, dtype=torch.int32,
                            device=device))


@dataclasses.dataclass(frozen=True)
class TileTally:
    """What a launch adds into: ``acc`` the tallies [3 * nx * ny] f32 and
    ``counts`` int64 [N_COUNTS]: photons started, slots with work left,
    lane-steps run with a live photon, real collisions."""

    acc: torch.Tensor
    counts: torch.Tensor

    @staticmethod
    def zeros(prm: TileParams, device) -> "TileTally":
        return TileTally(
            acc=torch.zeros(prm.n_acc, dtype=torch.float32, device=device),
            counts=torch.zeros(N_COUNTS, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# Plain PyTorch pass
# ---------------------------------------------------------------------------

def _exit_dist(px, py, pz, ux, uy, uz, bx0, bx1, by0, by1, bz0, bz1):
    """Distance to the exit of the box along the direction and its axis
    masks, ties broken x, then y, then z (pallas_tile.py:437-468)."""

    def axis(p, u, b0, b1):
        s = torch.where(u.abs() > 1e-12,
                        (torch.where(u >= 0, b1, b0) - p)
                        / torch.where(u == 0, 1.0, u), _BIG)
        return torch.clamp(s, min=0.0)

    sx, sy, sz = axis(px, ux, bx0, bx1), axis(py, uy, by0, by1), axis(
        pz, uz, bz0, bz1)
    is_x = (sx <= sy) & (sx <= sz)
    is_y = ~is_x & (sy <= sz)
    is_z = ~is_x & ~is_y
    return torch.minimum(sx, torch.minimum(sy, sz)), is_x, is_y, is_z


def _decode(t: torch.Tensor, nty: int, ntz: int):
    ta = t // (nty * ntz)
    rem = t - ta * (nty * ntz)
    tb = rem // ntz
    return ta, tb, rem - tb * ntz


def _fresh(prm: TileParams, us: torch.Tensor) -> tuple:
    """Fresh photons of the source from the injection uniforms ``us`` [4,
    n] (entry x, entry y, the source's azimuth or mu, the flux source's
    azimuth): their state [7, n] (entry at the top, one point for the
    spotlight, weight 1) and the tile under the entry point in the top
    layer of tiles, int32 [n] (pallas_tile.py:877-921; csrc/tile_kernel.cu
    inject)."""
    p = prm
    nx, ny, _ = p.shape
    tx, ty, _ = p.tiles
    _, nty, ntz = p.n_tiles_xyz
    x0, lx, y0, ly = p[P_X0], p[P_LX], p[P_Y0], p[P_LY]
    kind = p.source_kind
    if kind == illumination.SPOTLIGHT:
        fx = _F32(x0) + p.spot_x * _F32(lx)
        fy = _F32(y0) + p.spot_y * _F32(ly)
        x_new = torch.full_like(us[0], float(fx))
        y_new = torch.full_like(us[0], float(fy))
    else:
        x_new = x0 + us[0] * lx
        y_new = y0 + us[1] * ly
    if kind in (illumination.DIRECTIONAL, illumination.SPOTLIGHT):
        uz_new = torch.full_like(us[0], -float(p.smu))
        ux_new = torch.full_like(us[0], float(p.sux))
        uy_new = torch.full_like(us[0], float(p.suy))
    else:
        if kind == illumination.RANDOM_AZIMUTH:
            mu = torch.full_like(us[0], float(p.smu))
            phi = p[P_TWO_PI] * us[2]
        else:  # flux: mu = sqrt(u), azimuth at the fourth draw
            mu = torch.sqrt(torch.clamp(us[2], min=1e-12))
            phi = p[P_TWO_PI] * us[3]
        s_sin = torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0))
        uz_new = -mu
        ux_new = s_sin * torch.cos(phi)
        uy_new = s_sin * torch.sin(phi)
    fresh = torch.stack([x_new, y_new,
                         torch.full_like(x_new, p[P_ZHI]), ux_new, uy_new,
                         uz_new, torch.ones_like(x_new)])
    ix = ((x_new - x0) * p[P_INV_DX]).to(torch.int32).clamp(0, nx - 1)
    iy = ((y_new - y0) * p[P_INV_DY]).to(torch.int32).clamp(0, ny - 1)
    top = ((ix // tx) * nty + iy // ty) * ntz + (ntz - 1)
    return fresh, top.to(torch.int32)


def tile_pass_plain(pool: TilePool, fld: TileFields, prm: TileParams,
                    seed: int, step0: int, k_steps: int, tally: TileTally,
                    follow: bool = False, refill: bool = False) -> None:
    """One launch over the pool, every slot taking up to ``k_steps`` steps
    (counters ``step0`` on) while its photon stays in its tile, or with
    ``follow`` into whatever tile it crosses into; with ``refill`` (which
    follows) a dead slot whose ``pool.quota`` is above 0 first starts a
    fresh photon from the injection draws of the step's counter. Updates
    ``pool`` (its fields are rebound) and adds into ``tally``. Operation
    for operation the JAX kernel's float32 arithmetic (pallas_tile.py
    _build_tile_kernel)."""
    p = prm
    nx, ny, nz = p.shape
    tx, ty, tz = p.tiles
    ntx, nty, ntz = p.n_tiles_xyz
    n_tiles = p.n_tiles
    nxy = nx * ny
    x0, lx, y0, ly, z0 = p[P_X0], p[P_LX], p[P_Y0], p[P_LY], p[P_Z0]
    z_max, z_lo, z_hi = p[P_ZMAX], p[P_ZLO], p[P_ZHI]
    inv_dx, inv_dy, inv_dz = p[P_INV_DX], p[P_INV_DY], p[P_INV_DZ]
    txp, typ, tzp, nudge = p[P_TXP], p[P_TYP], p[P_TZP], p[P_NUDGE]
    dev = pool.st.device
    x, y, z, ux, uy, uz, w = pool.st.unbind(0)
    f = fld.fields
    u = rng.make_uniform(torch.arange(pool.tile.shape[0], dtype=torch.int64,
                                      device=dev), seed)
    tile_l = pool.tile.long()
    one_m_ssa_u = float(_F32(1.0) - _F32(p[P_SSA_U]))
    follow = follow or refill
    quota = pool.quota if refill else None
    started = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = None
    for k in range(k_steps):
        ctr = step0 + k
        if refill:
            # ---- a dead slot with quota left starts a photon ----
            take = (tile_l >= n_tiles) & (quota > 0)
            if bool(take.any()):
                fresh, top = _fresh(p, torch.stack(
                    [u(ctr, s) for s in INJECTION_SITES]))
                x, y, z, ux, uy, uz, w = (
                    torch.where(take, a, b) for a, b in zip(
                        fresh.unbind(0), (x, y, z, ux, uy, uz, w)))
                tile_l = torch.where(take, top.long(), tile_l)
                quota = quota - take.to(torch.int32)
                started = started + take.sum()
        if t0 is None or follow:
            # the tile the slot steps in: its indices, box and majorant
            t0 = tile_l
            maj = fld.majs[t0]
            ta, tb, tc = _decode(torch.clamp(t0, max=n_tiles - 1), nty, ntz)
            tx0p = x0 + ta.to(torch.float32) * txp
            ty0p = y0 + tb.to(torch.float32) * typ
            tz0p = z0 + tc.to(torch.float32) * tzp
            tx1p, ty1p, tz1p = tx0p + txp, ty0p + typ, tz0p + tzp
            gx0, gy0, gz0 = ta * tx, tb * ty, tc * tz
        active = (tile_l < n_tiles) & (tile_l == t0)
        if not bool(active.any()):
            break
        phi_rot = p[P_TWO_PI] * u(ctr, SITE_PHI)
        u_ang = u(ctr, SITE_ANGLE)

        # ---- Woodcock jump against the tile majorant, clipped at the
        # tile box ----
        tau = -torch.log1p(-u(ctr, SITE_TAU))
        d_samp = torch.where(maj > _TINY, tau / torch.clamp(maj, min=_TINY),
                             _BIG)
        t_exit, is_x, is_y, is_z = _exit_dist(x, y, z, ux, uy, uz, tx0p, tx1p,
                                              ty0p, ty1p, tz0p, tz1p)
        collide = active & (d_samp < t_exit)
        d = torch.where(collide, d_samp, t_exit + nudge)
        xn, yn, zn = x + ux * d, y + uy * d, z + uz * d
        cross = active & ~collide
        # domain z-exits are topological: z faces of boundary tiles
        exit_top = cross & is_z & (uz > 0) & (tc == ntz - 1)
        exit_bot = cross & is_z & (uz < 0) & (tc == 0)
        crossed = cross & ~exit_top & ~exit_bot

        # exit column, from the wrapped exit point relative to the tile
        z_b = torch.where(exit_top, z_max, z0)
        t_b = (z_b - z) / torch.where(uz.abs() < 1e-12, 1.0, uz)
        xe = x0 + torch.remainder((x + ux * t_b) - x0, lx)
        ye = y0 + torch.remainder((y + uy * t_b) - y0, ly)
        lixe = ((xe - tx0p) * inv_dx).to(torch.int32).clamp(0, tx - 1)
        liye = ((ye - ty0p) * inv_dy).to(torch.int32).clamp(0, ty - 1)
        col_e = (gx0 + lixe) * ny + (gy0 + liye)

        # collision cell, relative to the tile origin and clipped
        lix = ((xn - tx0p) * inv_dx).to(torch.int32).clamp(0, tx - 1)
        liy = ((yn - ty0p) * inv_dy).to(torch.int32).clamp(0, ty - 1)
        liz = ((zn - tz0p) * inv_dz).to(torch.int32).clamp(0, tz - 1)
        col_c = (gx0 + lix) * ny + (gy0 + liy)
        cell = col_c * nz + (gz0 + liz)

        # ---- field fetch ----
        beta = f[0][cell]
        if p.ncomp == 1:
            ssa = f[1][cell] if p.need_ssa else None
            f2 = f[1 + int(p.need_ssa)][cell] if p.need_f2 else None
        else:
            # effective ssa and the component by one uniform against the
            # cumulative scattering fractions
            ssa = f[1][cell]
            u_cmp = u(ctr, SITE_COMPONENT)
            fb = 1 + p.ncomp
            pick = (u_cmp >= f[2][cell]).to(torch.int64)
            if p.ncomp == 3:
                pick = torch.where(u_cmp >= f[3][cell], 2, pick)
            f2 = f[fb:fb + p.ncomp][pick, cell]

        real = collide & (u(ctr, SITE_COLLIDE) * maj < beta)
        if ssa is None:
            absorbed = torch.where(real, w * one_m_ssa_u, 0.0)
            w = torch.where(real, w * p[P_SSA_U], w)
        else:
            absorbed = torch.where(real, w * (1.0 - ssa), 0.0)
            w = torch.where(real, w * ssa, w)

        # ---- Russian roulette ----
        if p.use_rr:
            rr_w = p[P_RR_W]
            play = real & (w < p[P_HALF_RR])
            survive = u(ctr, SITE_ROULETTE) < rk.div_scalar(w, rr_w)
            w = torch.where(play, torch.where(survive, rr_w, 0.0), w)
        died_w = real & (w <= _TINY)
        scatter = real & ~died_w

        # ---- scatter: analytic HG or the tabulated inverse CDF ----
        if p.analytic_hg:
            g = f2 if f2 is not None else torch.full_like(u_ang, p[P_G_U])
            cos_t = sample_hg_cos(g, u_ang)
        else:
            n_steps = p.inv_n_steps
            t_u = u_ang * float(n_steps - 1)
            k_i = t_u.to(torch.int32).clamp(0, n_steps - 2)
            frac = t_u - k_i.to(torch.float32)
            flat = k_i.long()
            if f2 is not None:
                flat = flat + (f2 + 0.5).to(torch.int32).long() * n_steps
            cos_t = torch.cos(fld.inv_a0[flat] + frac * fld.inv_dd[flat])
        ox, oy, oz = rotate_direction(ux, uy, uz, cos_t, phi_rot)

        # ---- crossing into the neighbour tile (periodic x/y) and the
        # empty-tile skip chain, which parks at the top and bottom ----
        xw = x0 + torch.remainder(xn - x0, lx)
        yw = y0 + torch.remainder(yn - y0, ly)
        zw = torch.clamp(zn, z_lo, z_hi)
        sgx = torch.where(ux >= 0, 1, -1)
        sgy = torch.where(uy >= 0, 1, -1)
        sgz = torch.where(uz >= 0, 1, -1)
        na = torch.where(is_x, torch.remainder(ta + sgx, ntx), ta)
        nb = torch.where(is_y, torch.remainder(tb + sgy, nty), tb)
        nc = torch.where(is_z, tc + sgz, tc)
        tl = (na * nty + nb) * ntz + nc
        for _ in range(p.skip_iters):
            sk = crossed & (fld.majs[torch.clamp(tl, 0, n_tiles)] <= 0.0)
            tal, tbl, tcl = _decode(tl, nty, ntz)
            bx0 = x0 + tal.to(torch.float32) * txp
            by0 = y0 + tbl.to(torch.float32) * typ
            bz0 = z0 + tcl.to(torch.float32) * tzp
            t_x, sk_x, sk_y, sk_z = _exit_dist(xw, yw, zw, ux, uy, uz, bx0,
                                               bx0 + txp, by0, by0 + typ,
                                               bz0, bz0 + tzp)
            t_x = t_x + nudge
            zout = sk_z & (((tcl == ntz - 1) & (uz > 0))
                           | ((tcl == 0) & (uz < 0)))
            adv = sk & ~zout
            if not bool(adv.any()):
                break
            xw = torch.where(adv, x0 + torch.remainder((xw + ux * t_x) - x0,
                                                       lx), xw)
            yw = torch.where(adv, y0 + torch.remainder((yw + uy * t_x) - y0,
                                                       ly), yw)
            zw = torch.where(adv, torch.clamp(zw + uz * t_x, z_lo, z_hi), zw)
            sal = torch.where(sk_x, torch.remainder(tal + sgx, ntx), tal)
            sbl = torch.where(sk_y, torch.remainder(tbl + sgy, nty), tbl)
            scl = torch.where(sk_z, tcl + sgz, tcl)
            tl = torch.where(adv, (sal * nty + sbl) * ntz + scl, tl)

        # ---- Lambertian reflection (reuses u_ang and phi_rot) ----
        w_down = w
        mu_new = torch.sqrt(torch.clamp(u_ang, min=1e-12))
        sin_new = torch.sqrt(torch.clamp(1.0 - mu_new * mu_new, min=0.0))
        w_refl = w_down * p[P_ALBEDO]
        died_surface = exit_bot & (w_refl <= _TINY)
        reflected = exit_bot & ~died_surface

        # ---- commit ----
        x = torch.where(exit_bot, xe,
                        torch.where(crossed, xw, torch.where(collide, xn, x)))
        y = torch.where(exit_bot, ye,
                        torch.where(crossed, yw, torch.where(collide, yn, y)))
        z = torch.where(exit_bot, z_lo,
                        torch.where(crossed, zw,
                                    torch.where(collide,
                                                torch.clamp(zn, z0, z_max),
                                                z)))
        ux = torch.where(reflected, sin_new * torch.cos(phi_rot),
                         torch.where(scatter, ox, ux))
        uy = torch.where(reflected, sin_new * torch.sin(phi_rot),
                         torch.where(scatter, oy, uy))
        uz = torch.where(reflected, mu_new, torch.where(scatter, oz, uz))
        w = torch.where(reflected, w_refl, w)
        dead_now = exit_top | died_w | died_surface
        tile_l = torch.where(dead_now, n_tiles,
                             torch.where(crossed, tl, tile_l))

        # ---- tallies: one event per slot and step ----
        acc = tally.acc
        acc.index_add_(0, col_e.long(), torch.where(exit_top, w_down, 0.0))
        acc.index_add_(0, nxy + col_e.long(),
                       torch.where(exit_bot, w_down, 0.0))
        acc.index_add_(0, 2 * nxy + col_c.long(), absorbed)
        tally.counts[2:].add_(torch.stack([active.sum(), real.sum()]))

    pool.st = torch.stack([x, y, z, ux, uy, uz, w])
    pool.tile = tile_l.to(torch.int32)
    if refill:
        pool.quota = quota
        work = ((tile_l < n_tiles) | (quota > 0)).sum()
        tally.counts[:2].add_(torch.stack([started, work]))


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32


def _library():
    from mcbrat3d_tpu_torch import _build
    lib = _build.load("tile_kernel")
    if not getattr(lib, "_mcb_typed", False):
        lib.tile_kernel_num_params.restype = _I
        lib.tile_kernel_num_params.argtypes = []
        lib.tile_kernel_launch.restype = _I
        lib.tile_kernel_launch.argtypes = (
            [_P] * 10 + [_I] * 18 + [_U, _U] + [_I] * 6 + [_P])
        if lib.tile_kernel_num_params() != N_PARAMS:
            raise RuntimeError("csrc/tile_kernel.cu and tile_kernel.py "
                               "disagree on the parameter layout")
        lib._mcb_typed = True
    return lib


def _launch_cuda(pool: TilePool, fld: TileFields, prm: TileParams,
                 seed: int, step0: int, k_steps: int, tally: TileTally,
                 follow: bool, table_smem: int, refill: bool = False) -> None:
    global TILE_LAUNCHES
    dev = pool.st.device
    n_pad = pool.tile.shape[0]
    check = rk._check
    nx, ny, nz = prm.shape
    check(pool.st, "state", torch.float32, 7 * n_pad, dev)
    check(pool.tile, "tile", torch.int32, n_pad, dev)
    check(fld.fields, "fields", torch.float32, prm.n_f * nx * ny * nz, dev)
    check(fld.majs, "majorants", torch.float32, prm.n_tiles + 1, dev)
    inv_n = fld.inv_a0.numel()
    if not prm.analytic_hg and inv_n % prm.inv_n_steps:
        raise ValueError(f"inverse-CDF table has {inv_n} entries, not rows "
                         f"of {prm.inv_n_steps}")
    check(fld.inv_a0, "inv_a0", torch.float32, inv_n, dev)
    check(fld.inv_dd, "inv_dd", torch.float32, inv_n, dev)
    check(prm.device_values, "params", torch.float32, N_PARAMS, dev)
    check(tally.acc, "acc", torch.float32, prm.n_acc, dev)
    check(tally.counts, "counts", torch.int64, N_COUNTS, dev)
    if refill:
        check(pool.quota, "quota", torch.int32, n_pad, dev)
    if prm.n_tiles > MAX_TILES:
        raise ValueError(f"{prm.n_tiles} tiles > {MAX_TILES}")
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [prm.device_values, fld.fields, fld.majs, fld.inv_a0, fld.inv_dd,
            pool.st, pool.tile, pool.quota if refill else None, tally.acc,
            tally.counts]
    err = lib.tile_kernel_launch(
        *(t.data_ptr() if t is not None else None for t in ptrs), n_pad, nx,
        ny, nz, *prm.tiles, *prm.n_tiles_xyz, prm.n_f, int(prm.need_ssa),
        int(prm.need_f2), prm.ncomp, int(prm.analytic_hg), prm.inv_n_steps,
        inv_n, int(prm.use_rr), seed & 0xFFFF_FFFF, step0 & 0xFFFF_FFFF,
        k_steps, int(follow), prm.skip_iters, table_smem, int(refill),
        prm.src, stream)
    TILE_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"tile_kernel launch failed: CUDA error {err}")


def tile_pass(pool: TilePool, fld: TileFields, prm: TileParams, seed: int,
              step0: int, k_steps: int, tally: TileTally,
              follow: bool = False, table_smem: int = TABLE_SMEM,
              refill: bool = False) -> None:
    """One launch over the pool (``tile_pass_plain``'s arguments): the
    CUDA kernel for a pool on a CUDA device, the plain PyTorch pass for a
    pool on the CPU. ``table_smem`` is the kernel block's shared-memory
    budget for the inverse-CDF table in bytes (a smaller one sends the
    table to global reads; the plain pass has no such choice)."""
    if pool.st.is_cuda:
        _launch_cuda(pool, fld, prm, seed, step0, k_steps, tally, follow,
                     table_smem, refill)
    elif pool.st.device.type == "cpu":
        tile_pass_plain(pool, fld, prm, seed, step0, k_steps, tally, follow,
                        refill)
    else:
        raise ValueError(f"no tiled kernel for device {pool.st.device}")


# ---------------------------------------------------------------------------
# The schedules: the sorted passes (injection, sort and pack, kernel pass,
# tail) and the refill launches under relaunch_loop
# ---------------------------------------------------------------------------

def injection_uniforms(seed: int, pass_i: int, n_pad: int,
                       device) -> torch.Tensor:
    """[4, n_pad] uniforms of pass ``pass_i``'s injection, per slot: entry
    x, entry y, the source azimuth or mu, the flux source's azimuth."""
    u = rng.make_uniform(torch.arange(n_pad, dtype=torch.int64,
                                      device=device), seed)
    return torch.stack([u(pass_i, s) for s in INJECTION_SITES])


def _inject(pool: TilePool, prm: TileParams, us: torch.Tensor,
            quota: torch.Tensor, n_pool_r: int) -> torch.Tensor:
    """Fresh photons into the lowest-index dead slots, at most ``quota``
    and at most ``n_pool_r`` live in all (pallas_tile.py:877-921); returns
    the photons started."""
    n_tiles = prm.n_tiles
    n_pad = pool.tile.shape[0]
    dead = pool.tile >= n_tiles
    rank = torch.cumsum(dead.to(torch.int64), 0)
    cap = torch.clamp(n_pool_r - (n_pad - dead.sum()), min=0)
    take = dead & (rank <= torch.minimum(quota, cap))
    fresh, top = _fresh(prm, us)
    pool.st = torch.where(take, fresh, pool.st)
    pool.tile = torch.where(take, top, pool.tile)
    return take.sum()


def _pack(pool: TilePool, n_tiles: int, cohort: int) -> None:
    """Sort the live photons by (tile, slot) and pack each tile's photons
    from the start of a segment padded to a multiple of ``cohort`` slots,
    segments in tile order (pallas_tile.py:923-954): the j-th live photon
    of tile t moves to slot start(t) + j."""
    n_pad = pool.tile.shape[0]
    tiles_sorted, perm = torch.sort(pool.tile, stable=True)
    count = torch.bincount(pool.tile, minlength=n_tiles + 1)[:n_tiles]
    seg = torch.cumsum(count, 0) - count
    padded = (count + cohort - 1) // cohort * cohort
    start = torch.cumsum(padded, 0) - padded
    valid = tiles_sorted < n_tiles
    t = torch.clamp(tiles_sorted, max=n_tiles - 1).long()
    i = torch.arange(n_pad, dtype=torch.int64, device=pool.tile.device)
    dst = torch.where(valid, start[t] + (i - seg[t]), n_pad)
    st = torch.zeros(7, n_pad + 1, dtype=torch.float32, device=i.device)
    st[:, dst] = pool.st[:, perm]
    tile = torch.full((n_pad + 1,), n_tiles, dtype=torch.int32,
                      device=i.device)
    tile[dst] = tiles_sorted
    pool.st = st[:, :n_pad].contiguous()
    pool.tile = tile[:n_pad].contiguous()


@dataclasses.dataclass(frozen=True)
class TileRun:
    """One batch through the tiled kernel: unnormalized per-column tallies
    [nx, ny] and the run's counts."""

    flux_up: torch.Tensor
    flux_down: torch.Tensor
    flux_absorbed: torch.Tensor
    n_started: int
    n_bad: int
    n_passes: int   # sorted passes and tail passes, or refill launches
    n_tail: int     # tail passes
    lane_steps: int
    n_real: int


def run_batch_tile(domain: OpticalDomain, surface: Surface,
                   source: illumination.Source, seed: int,
                   tcfg: TileConfig, n_pool: int, n_photons: int,
                   use_russian_roulette: bool = True,
                   russian_roulette_weight: float = 1.0,
                   launch=tile_pass,
                   inject: Optional[Callable[[int, int], torch.Tensor]] = None
                   ) -> TileRun:
    """One photon batch through the tiled kernel (port of
    ``run_batch_pallas_tile`` and ``_make_tile_launch.launch``), on the
    schedule ``tcfg`` names.

    Sorted passes: ``n_pool`` is the pool's live-photon budget, rounded up
    to whole cohorts; the padded pool adds one cohort per tile;
    ``inject(pass_i, n_pad)``, when given, returns the [4, n_pad] injection
    uniforms of a pass in place of ``injection_uniforms``. Each pass reads
    back the quota left and the photons alive. Refill (``tcfg.refill``):
    ``n_pool`` slots, ``n_photons`` spread over them as quota, the launches
    of ``tcfg.k_steps`` steps driven by ``record_kernel.relaunch_loop`` up
    to ``tcfg.max_passes`` launches. ``seed`` is the uint32 kernel seed;
    ``launch`` is ``tile_pass`` (or, to compare the two on one device,
    ``tile_pass_plain``)."""
    reasons = tile_ineligibility_reasons(
        domain, surface, source, lw_mode=False, compute_intensity=False,
        record_scattering_orders=0, use_ray_tracing=False,
        need_volume_absorption=False)
    if tcfg.force_tiles is not None and "no tile plan" in reasons:
        reasons.remove("no tile plan")
    if reasons:
        raise NotImplementedError(
            "configuration outside the tiled kernel; failing predicates: "
            + "; ".join(reasons))
    tiles = tuple(tcfg.force_tiles or plan_for(domain))
    if any(n % t for n, t in zip(domain.grid.shape, tiles)):
        raise ValueError(f"tiles {tiles} do not divide the grid "
                         f"{domain.grid.shape}")
    dev = domain.device
    fld = TileFields.of(domain, tiles)
    prm = TileParams.make(domain, surface, source, tiles, tcfg,
                          use_russian_roulette, russian_roulette_weight)
    n_tiles = prm.n_tiles
    if n_tiles > MAX_TILES:
        raise ValueError(f"plan {tiles} has {n_tiles} tiles > {MAX_TILES}")
    if tcfg.refill:
        if inject is not None:
            raise ValueError("the refill mode injects in the kernel; "
                             "inject= applies to the sorted passes")
        return _refill_batch(fld, prm, seed, tcfg, int(n_pool),
                             int(n_photons), launch)
    cohort = tcfg.cohort
    n_pool_r = -(-int(n_pool) // cohort) * cohort
    n_pad = n_pool_r + n_tiles * cohort
    pool = TilePool.empty(n_pad, n_tiles, dev)
    tally = TileTally.zeros(prm, dev)
    quota = torch.tensor(int(n_photons), dtype=torch.int64, device=dev)
    started = torch.zeros((), dtype=torch.int64, device=dev)
    drain_floor = n_pool_r // tcfg.drain_div if tcfg.drain_div > 0 else 0
    quota_left, n_alive, n_passes = int(n_photons), 0, 0
    k = tcfg.k_steps
    while ((quota_left > 0 or n_alive > drain_floor)
           and n_passes < tcfg.max_passes):
        us = (inject(n_passes, n_pad) if inject is not None
              else injection_uniforms(seed, n_passes, n_pad, dev))
        n_inj = _inject(pool, prm, us.to(device=dev, dtype=torch.float32),
                        quota, n_pool_r)
        quota = quota - n_inj
        started = started + n_inj
        _pack(pool, n_tiles, cohort)
        launch(pool, fld, prm, seed, n_passes * k, k, tally)
        quota_left, n_alive = torch.stack(
            [quota, (pool.tile < n_tiles).sum()]).tolist()
        n_passes += 1
    # the tail: the stragglers follow their paths across tiles, counters
    # continuing past the sorted passes' counters
    step0, n_tail = n_passes * k, 0
    while n_alive > 0 and n_tail < tcfg.tail_passes and tcfg.tail_steps:
        launch(pool, fld, prm, seed, step0 + n_tail * tcfg.tail_steps,
               tcfg.tail_steps, tally, follow=True)
        n_alive = int((pool.tile < n_tiles).sum())
        n_tail += 1
    _, _, lane_steps, n_real = tally.counts.tolist()
    return _tile_run(prm, tally, int(started), n_alive, n_passes + n_tail,
                     n_tail, lane_steps, n_real)


def _tile_run(prm: TileParams, tally: TileTally, *counts) -> TileRun:
    nx, ny, _ = prm.shape
    nxy = nx * ny
    acc = tally.acc
    return TileRun(acc[:nxy].reshape(nx, ny),
                   acc[nxy:2 * nxy].reshape(nx, ny),
                   acc[2 * nxy:].reshape(nx, ny), *counts)


def _refill_batch(fld: TileFields, prm: TileParams, seed: int,
                  tcfg: TileConfig, n_slots: int, n_photons: int,
                  launch) -> TileRun:
    """The refill schedule: ``n_photons`` spread as quota over ``n_slots``
    slots (the first ``n_photons % n_slots`` take one more), launches of
    ``tcfg.k_steps`` steps in the kernel's refill mode driven by
    ``record_kernel.relaunch_loop`` (one read-back a launch, the unspent
    quota rebalanced evenly) until no slot has work left or
    ``tcfg.max_passes`` launches have run; the photons alive then are
    ``n_bad``."""
    dev = prm.device_values.device
    pool = TilePool.empty(n_slots, prm.n_tiles, dev)
    pool.quota = rk.initial_quota(n_slots, -(-n_photons // n_slots),
                                  n_photons, dev)
    tally = TileTally.zeros(prm, dev)
    k = tcfg.k_steps
    n_started, n_calls, lane_steps, n_real = rk.relaunch_loop(
        pool, tally.counts,
        lambda step0: launch(pool, fld, prm, seed, step0, k, tally,
                             refill=True),
        k, tcfg.max_passes * k, n_per_launch=N_COUNTS)
    n_bad = int((pool.tile < prm.n_tiles).sum())
    return _tile_run(prm, tally, n_started, n_bad, n_calls, 0, lane_steps,
                     n_real)


def refill_config(max_steps: int, k_steps: int = REFILL_STEPS) -> TileConfig:
    """The refill schedule of ``run_batch``: launches of ``k_steps``
    steps, at most ``max_steps`` steps in all (the reference's step
    cap)."""
    return TileConfig(refill=True, k_steps=k_steps,
                      max_passes=max(1, -(-max_steps // k_steps)))


def sorted_config(max_steps: int) -> TileConfig:
    """The sorted passes to the JAX package's drain floor (pool / 64
    alive), then a tail of ``TAIL_STEPS``-step passes in which the
    stragglers follow their paths across tiles, up to ``max_steps`` tail
    steps."""
    return TileConfig(tail_steps=TAIL_STEPS,
                      tail_passes=max(1, -(-max_steps // TAIL_STEPS)))


def run_batch_tile_tallies(domain, surface, source, seed: int, config,
                           n_photons=None, tcfg: Optional[TileConfig] = None,
                           launch=tile_pass, inject=None) -> Tallies:
    """``run_batch``-compatible entry (port of
    ``run_batch_pallas_tile_tallies``): the pool is the batch's lane count
    (``config.n_lanes``); ``n_steps`` and ``n_lane_steps`` are the
    lane-steps run with a live photon, ``n_passes`` the passes or
    launches.

    The default is the refill schedule (``refill_config``): the kernel
    starts and follows the photons across tiles under ``relaunch_loop``,
    up to ``config.max_steps`` steps, so that ``n_bad`` keeps the
    reference's meaning: photons cut by the step cap. ``tcfg=TileConfig()``
    runs the JAX package's sorted passes, which stop at its drain floor
    with up to pool / 64 photons alive and drop their weight (a bias of
    the fluxes by up to that share); ``sorted_config`` adds the tail."""
    if n_photons is None:
        n_photons = config.photons_per_batch
    if tcfg is None:
        tcfg = refill_config(config.max_steps)
    run = run_batch_tile(
        domain, surface, source, seed, tcfg, config.n_lanes,
        n_photons, use_russian_roulette=config.use_russian_roulette,
        russian_roulette_weight=config.russian_roulette_weight,
        launch=launch, inject=inject)
    return Tallies(
        flux_up=run.flux_up, flux_down=run.flux_down,
        flux_absorbed=run.flux_absorbed, volume_absorption=None,
        n_photons=run.n_started, n_bad=run.n_bad, n_steps=run.lane_steps,
        n_lane_steps=run.lane_steps, n_passes=run.n_passes,
        n_real=run.n_real)
