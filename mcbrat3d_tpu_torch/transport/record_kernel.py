"""Record kernel: the CUDA kernel, its plain PyTorch step and the relaunch
loop around them, for the flux path (K1) and in-kernel radiance (K2).

PyTorch counterpart of ``mcbrat3d_tpu.transport.pallas_kernel`` for the
record megakernel (``_build_kernel``, ``_make_launch``, ``run_batch_pallas``,
``run_batch_pallas_tallies``). Every lane carries one photon through
``steps_per_call`` transport steps per launch: refill from the source
(directional, random-azimuth, flux, spotlight, or thermal emission drawn
per voxel from a Walker alias table, with the ``lw_mode`` pre-credit of
-1 at the birth cell of every atmospheric emission), Woodcock jump against
the (optional two-level macro-cell) majorant, record fetch (one component,
or 2-3 components chosen by one uniform against the cell's cumulative
scattering fractions), null-collision test, absorption weight, Russian
roulette, HG or inverse-CDF scatter + rotation, reflection off the surface
(a uniform Lambertian albedo, the albedo of the landing column of a
per-pixel Lambertian grid, or the weight of a uniform Rahman-Pinty-
Verstraete BRDF for the sampled outgoing direction) and the fused tally of
flux up/down per column and absorption per column (``vol_tally=False``,
the JAX ``flux_abs_2d``) or per cell. With radiance
directions, every real scatter and every surface reflection also runs a
local estimate per direction: one cell DDA march to the domain top with the
periodic x/y wrap, the phase value (of the chosen component) from analytic
HG or a forward table resampled uniform in sin(theta/2), the exact or the
Iwabuchi roulette estimator and optional contribution capping with one
excess slot per component, tallied at the column where the ray leaves the
top (``pallas_kernel.py:1515-2115``); with ``lw_mode``, a newly emitted photon
first contributes its emission local estimate (weight 1) and moves from the
next step on (the "fresh hold").

Two implementations of one launch:

* ``csrc/record_kernel.cu``, one CUDA thread per lane (``_launch_cuda``);
* ``record_step_plain``, the same step on ``[n_lanes]`` tensors with masked
  ``torch.where`` selects, bit-faithful to the JAX kernel's float32
  arithmetic on the CPU; its local estimate marches every (event,
  direction) pair at once.

``record_launch`` sends CUDA tensors to the kernel and CPU tensors to the
plain step; there is no fallback between them. Both draw the same counter
uniforms (``core.rng``), so for a given seed they follow the same photon
paths up to float rounding. The plain step updates the state dataclass in
place (its fields are rebound), the kernel updates the state tensors in
place.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.domain.domain import (OpticalDomain,
                                              multi_component_records)
from mcbrat3d_tpu_torch.physics.surface import Surface, column_albedo
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport.integrator import (Tallies,
                                                     rotate_direction,
                                                     sample_hg_cos)

LANES_PER_ROW = 128
# Envelope shared with the JAX record kernel, so both dispatch the same
# domains (pallas_kernel.MAX_CELLS / MAX_INV_ENTRIES).
MAX_CELLS = 288 * 128
MAX_INV_ENTRIES = 1024 * 128
MAX_COMPONENTS = 3
# Launch counters (csrc/record_kernel.cu kCounts): photons started, lanes
# with work left, lane-steps with a live photon, real collisions, marches
# cut by the iteration bound, local-estimate events.
N_COUNTS = 6
# Per-pixel Lambertian budget of the JAX record kernel
# (pallas_kernel.SURF_PX_MAX_ROWS): its albedo grid is packed per domain
# column in at most 32 rows of 128, so K1 takes such a surface up to 4,096
# columns.
SURF_PX_MAX_ROWS = 32
# Sources the kernel refills from, by their code (csrc/record_kernel.cu
# SRC_*); emission needs the per-voxel alias tables (illumination.emission).
SOURCE_KINDS = (illumination.DIRECTIONAL, illumination.RANDOM_AZIMUTH,
                illumination.FLUX, illumination.SPOTLIGHT,
                illumination.EMISSION)

# Radiance launch geometry (pallas_kernel.py:3278-3291): local estimation
# runs per event and per direction, so lane occupancy decides its cost; the
# JAX package trades wave width for per-lane quota (at most 32 rows), and
# the port keeps those lane streams by default.
RADIANCE_ROWS = 32
# Forward phase table resampled on this many points uniform in
# s = sin(theta/2) (pallas_kernel._pack_forward_table).
FWD_N_S = 2048

# Kernel launches made by ``_launch_cuda`` in this process, all of them,
# those that ran the local estimate, those that ran the emission refill
# (the thermal source of LW runs) and those that reflected off a uniform
# RPV surface or a per-pixel Lambertian grid.
LAUNCHES = 0
RADIANCE_LAUNCHES = 0
LW_LAUNCHES = 0
RPV_LAUNCHES = 0
PX_LAUNCHES = 0

# Slots of the float32 parameter vector (csrc/record_kernel.cu P_*).
(P_BETA_MAX, P_INV_BETA_MAX, P_ALBEDO, P_SMU, P_SUX, P_SUY, P_RR_W,
 P_X0, P_LX, P_Y0, P_LY, P_Z0, P_LZ, P_INV_DX, P_INV_DY, P_INV_DZ,
 P_ZMAX, P_ZEPS, P_BXW, P_BYW, P_BZW, P_NUDGE, P_TWO_PI, P_HALF_RR,
 P_ZTOP, P_ZBOT, P_DXC, P_DYC, P_DZC, P_MNUDGE, P_ZETA, P_MAXC,
 P_SPOT_X, P_SPOT_Y, P_ATMS, P_RPV_K, P_RPV_TH, N_PARAMS) = range(38)

# Surface the kernel reflects off (csrc/record_kernel.cu SURF_*), a launch
# argument: the uniform Lambertian albedo (P_ALBEDO), a uniform RPV BRDF
# (rho0 in P_ALBEDO, k and theta in P_RPV_K, P_RPV_TH), a per-pixel
# Lambertian grid (an albedo per column, RecordTables.albedo).
SURF_LAMBERT, SURF_RPV, SURF_PX = range(3)

# Local-estimate phase source (csrc/record_kernel.cu PHASE_*): analytic HG,
# forward table row 0 (all-HG domains), forward table row = the record's
# phase index.
PHASE_HG, PHASE_TABLE_ROW0, PHASE_TABLE = range(3)
# Kind of a local-estimate event (csrc/record_kernel.cu EV_*): a scatter
# (phase value / (4 pi mu_d)), a surface reflection or surface emission
# (Lambertian 1/pi), an atmospheric emission (isotropic 1/(4 pi mu_d)).
EV_SCATTER, EV_LAMBERT, EV_ISOTROPIC = range(3)

_TINY = 1e-30
_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class RecordConfig:
    """Launch geometry (the flux-path subset of ``PallasConfig``)."""

    rows: int = 512
    steps_per_call: int = 128
    max_steps: int = 20_000
    # False: absorption tallied per column (JAX flux_abs_2d)
    vol_tally: bool = True

    @property
    def n_lanes(self) -> int:
        return self.rows * LANES_PER_ROW


def config_for(n_lanes: int, photons_per_lane: int, max_steps: int,
               vol_tally: bool = True) -> tuple:
    """Map a KernelConfig-shaped request onto launch geometry (port of
    ``pallas_kernel.config_for``): at most 512 rows of 128 lanes, the rest
    folded into per-lane quota, keeping rows*128*ppl >= the batch size."""
    total = n_lanes * photons_per_lane
    rows = max(8, min(512, n_lanes // LANES_PER_ROW))
    ppl = -(-total // (rows * LANES_PER_ROW))
    return RecordConfig(rows=rows, max_steps=max_steps,
                        vol_tally=vol_tally), ppl


def surface_px_ok(surface: Surface, grid, lw_mode: bool,
                  max_cols: int = LANES_PER_ROW * SURF_PX_MAX_ROWS) -> bool:
    """Whether a kernel takes ``surface`` as a per-pixel Lambertian albedo
    grid (port of ``pallas_kernel.surface_px_ok``).

    Exactness contract: each surface pixel tiles a whole number of domain
    columns (nx % nxs == 0, ny % nys == 0), so an albedo per column
    reproduces the reference's fractional surface-grid lookup
    (src/surfaceProperties.f95:119-147) exactly. False in ``lw_mode`` (the
    surface emission's pre-credit assumes the uniform albedo) and for a
    uniform surface (the scalar albedo covers it). ``max_cols`` is the
    kernel's column budget: the record kernel's 4,096 by default, the
    column kernel passes its own ``MAX_COLS``."""
    if lw_mode or not surface.is_lambertian_grid:
        return False
    if surface.is_uniform_lambertian:
        return False
    nxs, nys, _ = surface.params.shape
    nx, ny, _ = grid.shape
    return nx % nxs == 0 and ny % nys == 0 and nx * ny <= max_cols


def surface_kind(surface: Surface, grid, lw_mode: bool) -> int:
    """SURF_* of ``surface``, the choice of pallas_kernel.py:2771-2773:
    a uniform RPV surface, a per-pixel Lambertian grid that
    ``surface_px_ok`` takes, else the uniform Lambertian albedo; raises
    ValueError for any other surface (the record predicate refuses it)."""
    if surface.is_uniform_rpv:
        return SURF_RPV
    if surface_px_ok(surface, grid, lw_mode):
        return SURF_PX
    if surface.is_uniform_lambertian:
        return SURF_LAMBERT
    raise ValueError(
        f"the record kernel does not reflect off a {surface.brdf_name} "
        f"surface of {surface.params.shape[0]} x {surface.params.shape[1]} "
        f"pixels on a {tuple(grid.shape)} grid (lw_mode={lw_mode})")


def ineligibility_reasons(domain: OpticalDomain, surface: Surface,
                          source: illumination.Source,
                          lw_mode: bool, compute_intensity: bool,
                          record_scattering_orders: int,
                          use_ray_tracing: bool) -> list:
    """Names of every failing record-kernel predicate (empty = eligible).

    Port of ``pallas_kernel.ineligibility_reasons``, so the port picks
    the record kernel where the JAX package does: a uniform Lambertian or
    RPV surface, or a per-pixel Lambertian grid (``surface_px_ok``). An
    emission source is in-kernel when it carries its alias tables
    (``illumination.emission``), not when it is backed by a separable
    domain's tables (``emission_separable``)."""
    nx, ny, nz = domain.grid.shape
    n_cells = nx * ny * nz
    vol_base = -(-2 * nx * ny // 128) * 128
    inv_size = domain.tables.inverse.numel()
    checks = (
        ("domain has no cell records (built with device_fields='compact')",
         domain.cell_records is not None),
        (f"inverse-CDF table has {inv_size} entries > {MAX_INV_ENTRIES}",
         domain.all_hg or inv_size <= MAX_INV_ENTRIES),
        (f"n_components={domain.n_components} > {MAX_COMPONENTS}",
         domain.n_components <= MAX_COMPONENTS),
        ("irregular grid spacing",
         domain.grid.xy_regular and domain.grid.z_regular),
        ("non-uniform or unsupported-BRDF surface (in-kernel: uniform "
         "Lambertian, uniform RPV, or a per-pixel Lambertian grid that "
         f"divides the domain columns, <= {LANES_PER_ROW * SURF_PX_MAX_ROWS} "
         "columns, not lw_mode)",
         surface.is_uniform_lambertian or surface.is_uniform_rpv
         or surface_px_ok(surface, domain.grid, lw_mode)),
        (f"source kind {source.kind!r} not in-kernel",
         source.kind in SOURCE_KINDS[:4]
         or (source.kind == illumination.EMISSION
             and source.em_prob is not None)),
        ("lw_mode without an emission source",
         (not lw_mode) or source.kind == illumination.EMISSION),
        ("compute_intensity outside intensity_ineligibility_reasons",
         not compute_intensity),
        ("record_scattering_orders > 0", record_scattering_orders == 0),
        ("use_ray_tracing=True (the kernel is max-cross-section only)",
         not use_ray_tracing),
        (f"n_cells={n_cells} > {MAX_CELLS}", n_cells <= MAX_CELLS),
        (f"tally span {vol_base + n_cells} > {MAX_CELLS}",
         vol_base + n_cells <= MAX_CELLS),
    )
    return [name for name, ok in checks if not ok]


def intensity_ineligibility_reasons(domain: OpticalDomain, surface: Surface,
                                    source: illumination.Source,
                                    lw_mode: bool,
                                    record_scattering_orders: int,
                                    use_ray_tracing: bool,
                                    icfg: "le.IntensityConfig",
                                    dirs) -> list:
    """Names of every failing in-kernel local-estimation predicate (empty =
    eligible): the flux predicates plus those of
    ``pallas_kernel.intensity_ineligibility_reasons``."""
    reasons = ineligibility_reasons(
        domain, surface, source, lw_mode, compute_intensity=False,
        record_scattering_orders=record_scattering_orders,
        use_ray_tracing=use_ray_tracing)
    fwd = domain.tables.forward
    hyb_ok = (not icfg.use_hybrid_phase) or (
        fwd.shape[1] > 1 and (not domain.all_hg or fwd.shape[0] == 1))
    shape_ok = dirs is not None and tuple(dirs.shape) == (3, icfg.n_dirs)
    checks = (
        ("intensity needs phase values: an all-HG domain or computed "
         "forward tables (build_domain(compute_intensity_tables=True))",
         domain.all_hg or domain.tables.forward_orig.shape[1] > 1),
        ("use_hybrid_phase=True without usable forward tables (need "
         "compute_intensity_tables=True and, for all-HG domains, a single "
         "shared table row)", hyb_ok),
        ("n_orders_orig_phase > 0", icfg.n_orders_orig_phase == 0),
        (f"n_dirs={icfg.n_dirs} > {le.MAX_KERNEL_DIRS}",
         icfg.n_dirs <= le.MAX_KERNEL_DIRS),
        ("intensity_dirs is None" if dirs is None else
         f"dirs shape {tuple(dirs.shape)} != (3, {icfg.n_dirs})", shape_ok),
        (f"a direction's mu is below the floor pallas_min_mu="
         f"{icfg.pallas_min_mu} (default MIN_MU={le.MIN_MU}; the march "
         "bound would cut its marches short)",
         shape_ok and le.dirs_mu_floor_ok(icfg, dirs)),
        ("intensity with a non-Lambertian surface",
         surface.is_uniform_lambertian
         or surface_px_ok(surface, domain.grid, lw_mode)),
    )
    reasons.extend(name for name, ok in checks if not ok)
    return reasons


# ---------------------------------------------------------------------------
# Kernel inputs
# ---------------------------------------------------------------------------

def _phase_source(domain: OpticalDomain, icfg) -> int:
    """PHASE_* for a radiance run (pallas_kernel.run_batch_pallas_tallies:
    hybrid table, else analytic HG for all-HG domains, else the original
    table; a table's row is 0 on all-HG domains)."""
    if not icfg.use_hybrid_phase and domain.all_hg:
        return PHASE_HG
    return PHASE_TABLE_ROW0 if domain.all_hg else PHASE_TABLE


def _interp_rows(x: torch.Tensor, xp: torch.Tensor,
                 fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` per row of ``fp`` [rows, n], in float32."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    f = fp[:, i - 1] + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (
        fp[:, i] - fp[:, i - 1])
    f = torch.where(x < xp[0], fp[:, :1], f)
    return torch.where(x > xp[-1], fp[:, -1:], f)


def forward_table(domain: OpticalDomain, use_hybrid: bool):
    """(v0, delta): the forward phase table resampled onto ``FWD_N_S`` points
    uniform in s = sin(theta/2), flattened row-major, with forward
    differences for the lerp (port of ``pallas_kernel._pack_forward_table``
    without its bf16 hi/lo split). The index of a scattering cosine c is
    then sqrt((1 - c)/2) * (FWD_N_S - 1): a square root, no arccos. Computed in
    float32 on the host and cached on the domain."""
    cache = domain.__dict__.setdefault("_forward_table_cache", {})
    key = bool(use_hybrid)
    if key not in cache:
        table = (domain.tables.forward if use_hybrid
                 else domain.tables.forward_orig).cpu()
        angles = torch.linspace(0.0, np.pi, table.shape[1])
        theta_s = 2.0 * torch.asin(torch.linspace(0.0, 1.0, FWD_N_S))
        flat = _interp_rows(theta_s, angles, table).reshape(-1)
        delta = torch.cat([flat[1:], flat[-1:]]) - flat
        cache[key] = (flat.to(domain.device).contiguous(),
                      delta.to(domain.device).contiguous())
    return cache[key]


def inverse_table(domain: OpticalDomain):
    """(a0, delta): the stacked inverse-CDF angle table flattened row-major
    (flat index row * n_steps + k) and its forward differences for the
    lerp, the same float32 deltas as pallas_kernel._pack_inverse_table."""
    a0 = domain.tables.inverse.reshape(-1).contiguous()
    return a0, (torch.cat([a0[1:], a0[-1:]]) - a0).contiguous()


@dataclasses.dataclass
class RecordState:
    """Per-lane photon state, struct of arrays ([n_lanes] each)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    w: torch.Tensor
    bl: torch.Tensor      # carried local (macro-block) majorant
    quota: torch.Tensor   # int32 photons still to start on this lane
    alive: torch.Tensor   # int32 0/1

    FLOAT_FIELDS = ("x", "y", "z", "ux", "uy", "uz", "w", "bl")
    INT_FIELDS = ("quota", "alive")

    @staticmethod
    def initial(quota: torch.Tensor, beta_max: float) -> "RecordState":
        """Fresh lanes: no photon alive, ``quota`` photons to start."""
        n = quota.shape[0]
        dev = quota.device

        def full(v):
            return torch.full((n,), v, dtype=torch.float32, device=dev)

        return RecordState(x=full(0.0), y=full(0.0), z=full(0.0),
                           ux=full(0.0), uy=full(0.0), uz=full(1.0),
                           w=full(0.0), bl=full(beta_max),
                           quota=quota.to(torch.int32).contiguous(),
                           alive=torch.zeros(n, dtype=torch.int32,
                                             device=dev))


@dataclasses.dataclass(frozen=True)
class RecordTables:
    """Device tables the step reads: records [n_cells, stride] f32 (the
    domain's ``cell_records`` for one component, its
    ``multi_component_records`` for 2-3), the flat inverse-CDF angles with
    their forward differences, for radiance the direction cosines
    [3, n_dirs] and the resampled forward phase table (``forward_table``),
    for a per-voxel emission source its Walker alias pair [n_cells]
    (acceptance, alias target; f32, kernel cell order), and for a per-pixel
    Lambertian surface its albedo per column [nx*ny] (``column_albedo``);
    one-element placeholders otherwise."""

    records: torch.Tensor
    inv_a0: torch.Tensor
    inv_dd: torch.Tensor
    dirs: torch.Tensor
    fwd_v0: torch.Tensor
    fwd_dd: torch.Tensor
    em_prob: torch.Tensor = None
    em_alias: torch.Tensor = None
    albedo: torch.Tensor = None

    @staticmethod
    def from_domain(domain: OpticalDomain, intensity_config=None,
                    intensity_dirs=None, source=None,
                    surface: Surface = None) -> "RecordTables":
        rec = (domain.cell_records.contiguous()
               if domain.n_components == 1
               else multi_component_records(domain))
        zero = torch.zeros(1, dtype=torch.float32, device=rec.device)
        a0, dd = (zero, zero) if domain.all_hg else inverse_table(domain)
        dirs, v0, fdd = zero, zero, zero
        if intensity_config is not None:
            dirs = intensity_dirs.to(device=rec.device,
                                     dtype=torch.float32).contiguous()
            if _phase_source(domain, intensity_config) != PHASE_HG:
                v0, fdd = forward_table(domain,
                                        intensity_config.use_hybrid_phase)
        em_prob = em_alias = zero
        if source is not None and source.kind == illumination.EMISSION:
            em_prob = source.em_prob.to(rec.device).contiguous()
            em_alias = source.em_alias.to(rec.device).contiguous()
        albedo = zero
        if (surface is not None and surface.is_lambertian_grid
                and not surface.is_uniform_lambertian):
            nx, ny, _ = domain.grid.shape
            albedo = column_albedo(surface, nx, ny, rec.device)
        return RecordTables(records=rec, inv_a0=a0, inv_dd=dd, dirs=dirs,
                            fwd_v0=v0, fwd_dd=fdd, em_prob=em_prob,
                            em_alias=em_alias, albedo=albedo)


@dataclasses.dataclass(frozen=True)
class RecordParams:
    """Scalars of one batch: ``values`` is the float32 parameter vector
    (P_* slots, computed in float32 as the JAX launch computes them),
    ``device_values`` its copy on the kernel's device. ``source_kind``
    indexes ``SOURCE_KINDS``; ``ncomp`` > 1 reads the 8-column
    multi-component record. ``lw`` (lw_mode with an emission source)
    pre-credits -1 to the volume tally at each atmospheric birth and, with
    radiance, holds a newly emitted photon for its emission local
    estimate. ``surface`` (SURF_*) picks the reflection. ``n_dirs`` > 0
    turns on the local estimate with the ``le_*`` switches."""

    values: np.ndarray
    device_values: torch.Tensor
    nx: int
    ny: int
    nz: int
    macro_factor: int
    stride: int
    off_ssa: int
    off_f2: int
    analytic_hg: bool
    inv_n_steps: int
    use_rr: bool
    vol_tally: bool
    source_kind: int = 0
    ncomp: int = 1
    lw: bool = False
    surface: int = SURF_LAMBERT
    n_dirs: int = 0
    le_phase: int = PHASE_HG
    le_rr: bool = False      # Iwabuchi roulette estimator
    le_cap: bool = False     # limitIntensityContributions
    k_dda: int = 0           # march iteration bound

    def __getitem__(self, slot: int) -> float:
        return float(self.values[slot])

    @property
    def n_acc(self) -> int:
        """Tally entries: [up nxy | down nxy | absorbed nxy or nxyz]."""
        nxy = self.nx * self.ny
        return 2 * nxy + (nxy * self.nz if self.vol_tally else nxy)

    @property
    def n_sec(self) -> int:
        """Image sections: one, or with the cap one per slot (slot 0 =
        surface reflection, slot 1 + c = scattering component c)."""
        return self.ncomp + 1 if self.le_cap else 1

    @property
    def n_img(self) -> int:
        """Radiance tally entries: [section][direction][column]."""
        return self.n_sec * self.n_dirs * self.nx * self.ny

    @property
    def n_exc(self) -> int:
        """Capped excess entries: [slot][direction] (0 without the cap)."""
        return self.n_sec * self.n_dirs if self.le_cap else 0

    @staticmethod
    def make(domain: OpticalDomain, surface: Surface,
             source: illumination.Source, use_russian_roulette: bool,
             russian_roulette_weight: float, vol_tally: bool,
             intensity_config=None, intensity_dirs=None,
             lw_mode: bool = False) -> "RecordParams":
        f = _F32
        nx, ny, nz = domain.grid.shape
        xe, ye, ze = domain.grid.edges_f32()
        beta_max = max(f(domain.max_extinction), f(_TINY))
        smu = f(source.solar_mu)
        sphi = f(source.solar_azimuth)
        sth = np.sqrt(max(f(0.0), f(1.0) - smu * smu))
        lx, ly, lz = xe[-1] - xe[0], ye[-1] - ye[0], ze[-1] - ze[0]
        mf = int(domain.macro_factor)
        bxw, byw, bzw = (lx / f(nx) * f(mf), ly / f(ny) * f(mf),
                         lz / f(nz) * f(mf))
        rr_w = f(russian_roulette_weight)
        z_max, z_eps = ze[0] + lz, lz * f(1e-6)
        dxc, dyc, dzc = lx / f(nx), ly / f(ny), lz / f(nz)
        vals = np.zeros(N_PARAMS, np.float32)
        vals[[P_BETA_MAX, P_INV_BETA_MAX, P_ALBEDO, P_SMU, P_SUX, P_SUY,
              P_RR_W]] = (beta_max, f(1.0) / beta_max, f(surface.albedo),
                          smu, sth * np.cos(sphi), sth * np.sin(sphi), rr_w)
        vals[[P_X0, P_LX, P_Y0, P_LY, P_Z0, P_LZ]] = (
            xe[0], lx, ye[0], ly, ze[0], lz)
        vals[[P_INV_DX, P_INV_DY, P_INV_DZ, P_ZMAX, P_ZEPS]] = (
            f(nx) / lx, f(ny) / ly, f(nz) / lz, z_max, z_eps)
        vals[[P_BXW, P_BYW, P_BZW, P_NUDGE]] = (
            bxw, byw, bzw, f(1e-5) * min(bxw, min(byw, bzw)))
        vals[[P_TWO_PI, P_HALF_RR, P_ZTOP, P_ZBOT]] = (
            f(2.0 * np.pi), f(0.5) * rr_w, z_max - z_eps, ze[0] + z_eps)
        # local-estimate march: cell sizes and the distance nudge of
        # pallas_kernel.py:1538-1541
        vals[[P_DXC, P_DYC, P_DZC, P_MNUDGE]] = (
            dxc, dyc, dzc, f(1e-6) * min(dzc, min(dxc, dyc)))
        # spotlight entry point as fractions of the domain (JAX params
        # 17/18, read from solar_x/solar_y; pallas_kernel.py:2755-2758)
        if source.kind == illumination.SPOTLIGHT:
            vals[[P_SPOT_X, P_SPOT_Y]] = (f(source.solar_x),
                                          f(source.solar_y))
        # emission: fracAtmsPower (JAX params 16)
        emission = source.kind == illumination.EMISSION
        if emission:
            vals[P_ATMS] = f(source.atms_fraction)
        lw = bool(lw_mode) and emission
        if lw and not vol_tally:
            raise ValueError("lw_mode pre-credits need the 3D volume tally")
        # the surface (pallas_kernel.py:2851-2872): rho0 rides P_ALBEDO,
        # the RPV k and theta are JAX's params 20 and 21
        kind = surface_kind(surface, domain.grid, lw)
        if kind == SURF_RPV:
            if intensity_config is not None:
                # the local estimate's surface term is Lambertian's 1/pi
                # (pallas_kernel.py:343-352)
                raise ValueError("the record kernel's local estimate takes "
                                 "no intensity with a non-Lambertian "
                                 "surface")
            vals[[P_RPV_K, P_RPV_TH]] = surface.params.reshape(-1)[1:3]
        icfg = intensity_config
        le_kw = {}
        if icfg is not None:
            vals[[P_ZETA, P_MAXC]] = (f(icfg.zeta_min),
                                      f(icfg.max_contribution))
            le_kw = dict(n_dirs=int(icfg.n_dirs),
                         le_phase=_phase_source(domain, icfg),
                         le_rr=bool(icfg.use_russian_roulette),
                         le_cap=bool(icfg.limit_contributions),
                         k_dda=le.march_bound(domain.grid, intensity_dirs,
                                              icfg.pallas_min_mu))
        ncomp = domain.n_components
        if ncomp == 1:  # the domain's cell_records
            layout = dict(stride=6, off_ssa=3, off_f2=5 if domain.all_hg
                          else 4)
        else:  # multi_component_records: ssa_eff, f2 of component 0
            layout = dict(stride=8, off_ssa=2, off_f2=5)
        return RecordParams(
            values=vals,
            device_values=torch.as_tensor(vals, device=domain.device),
            nx=nx, ny=ny, nz=nz, macro_factor=mf, **layout,
            analytic_hg=bool(domain.all_hg),
            inv_n_steps=int(domain.tables.inverse.shape[1]),
            use_rr=bool(use_russian_roulette), vol_tally=bool(vol_tally),
            source_kind=SOURCE_KINDS.index(source.kind), ncomp=ncomp,
            lw=lw, surface=kind, **le_kw)


# ---------------------------------------------------------------------------
# Plain PyTorch step
# ---------------------------------------------------------------------------

def div_scalar(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded as the kernels round it: PyTorch's CUDA division
    by a host scalar multiplies by the scalar's reciprocal instead, which is
    one ulp off for some quotients."""
    return a / torch.full_like(a, b)


def face_distance(pos, p0, d, bw, length):
    """Distance along ``d`` to the next macro-block face, the face clamped
    to the domain edge [0, length] (a partial last block's outer face lies
    past the periodic seam; pallas_kernel.py:1052-1066)."""
    t = (torch.clamp((torch.floor(div_scalar(pos - p0, bw))
                      + (d >= 0).to(torch.float32)) * bw,
                     0.0, length) + p0) - pos
    return torch.where(d.abs() > 1e-12, t / torch.where(d == 0, 1.0, d),
                       3e38)


def cell_indices(v: torch.Tensor, ny: int, nz: int) -> tuple:
    """(ix, iy, iz) of the cells ``v`` = (ix*ny + iy)*nz + iz, by integer
    division as the kernel does (the JAX kernel's floored float32 divides,
    pallas_kernel.py:951-956, give the same cells within the envelope)."""
    col = torch.div(v, nz, rounding_mode="floor")
    ix = torch.div(col, ny, rounding_mode="floor")
    return ix, col - ix * ny, v - col * nz


def emission_refill(u, ctr: int, tab: RecordTables, p: RecordParams):
    """The BBEmission refill of every lane (pallas_kernel.py:897-987):
    returns the birth point (x, y, z), mu, the atmosphere/surface split
    and the birth cell (ix*ny + iy)*nz + iz.

    One uniform against fracAtmsPower splits atmosphere from surface; the
    emitting voxel is a Walker alias draw (a uniform bin, accepted with its
    probability, else its alias); the photon starts uniform in that voxel
    (z kept z_eps inside the domain) with an isotropic mu whose magnitude
    is at least 1e-4, or uniform on the surface with a Lambertian
    mu = sqrt(u) upward (reference: src/monteCarloIllumination.f95:487-509).
    The JAX kernel decomposes the cell with floored float32 divides; the
    port divides integers (``cell_indices``)."""
    nx, ny, nz = p.nx, p.ny, p.nz
    x0, y0, z0 = p[P_X0], p[P_Y0], p[P_Z0]
    u0 = u(ctr, rng.SITE_X)
    u1 = u(ctr, rng.SITE_Y)
    from_atm = u(ctr, rng.SITE_EM_SPLIT) < p[P_ATMS]
    n_cells = nx * ny * nz
    jbin = torch.clamp((u(ctr, rng.SITE_EM_BIN) * float(n_cells)).to(
        torch.int32), max=n_cells - 1)
    p_j = tab.em_prob[jbin.long()]
    a_j = tab.em_alias[jbin.long()]
    v = torch.where(u(ctr, rng.SITE_EM_ACCEPT) < p_j, jbin,
                    (a_j + 0.5).to(torch.int32))
    ix, iy, iz = cell_indices(v, ny, nz)
    xa = x0 + (ix.to(torch.float32) + u0) * p[P_DXC]
    ya = y0 + (iy.to(torch.float32) + u1) * p[P_DYC]
    za = torch.clamp(z0 + (iz.to(torch.float32) + u(ctr, rng.SITE_SOURCE))
                     * p[P_DZC], p[P_ZBOT], p[P_ZTOP])
    u_mu = u(ctr, rng.SITE_EM_MU)
    mu_a = 1.0 - 2.0 * u_mu
    mu_a = torch.where(mu_a.abs() < 1e-4, torch.sign(mu_a + _TINY) * 1e-4,
                       mu_a)
    mu_sfc = torch.sqrt(torch.clamp(u_mu, min=1e-12))
    return (torch.where(from_atm, xa, x0 + u0 * p[P_LX]),
            torch.where(from_atm, ya, y0 + u1 * p[P_LY]),
            torch.where(from_atm, za, p[P_ZBOT]),
            torch.where(from_atm, mu_a, mu_sfc), from_atm, v)


def rpv_weight(rho0: float, k: float, theta: float, ux, uy, uz, mu_new,
               sin_new, cos_phi, sin_phi):
    """The uniform RPV BRDF's reflectance for a photon reaching the surface
    along (ux, uy, uz) and leaving with the sampled cosine ``mu_new`` (sine
    ``sin_new``) at azimuth phi (its cosine and sine), in the JAX kernel's
    trig-free float32 form (pallas_kernel.py:1440-1477): cos(phi - phi_in)
    from the direction components, tan(acos(mu)) as sqrt(1 - mu^2) / mu.
    It equals ``physics.surface.rpv_reflectance`` of (rho0, k, theta) at
    mu_in = |uz|, mu_out = mu_new to float rounding."""
    f = _F32
    rho0, k, th = f(rho0), f(k), f(theta)
    mu_i = uz.abs()
    si = torch.sqrt(torch.clamp(1.0 - uz * uz, min=0.0))
    mu_r = torch.clamp(mu_new, 1e-6, 1.0)
    cos_dphi = torch.where(si < 1e-6, 1.0,
                           (cos_phi * ux + sin_phi * uy)
                           / torch.where(si < 1e-6, 1.0, si))
    cos_g = mu_i * mu_r + (si * sin_new) * cos_dphi
    minn_x = torch.clamp((mu_i * mu_r) * (mu_i + mu_r), min=1e-12)
    minnaert = torch.exp(float(k - f(1.0)) * torch.log(minn_x))
    hg_d = torch.clamp(float(f(1.0) + th * th) + float(f(2.0) * th) * cos_g,
                       min=1e-12)
    # a scalar over a tensor is a reciprocal and a product in PyTorch:
    # divide tensors, as the kernel does
    hg_l = torch.full_like(hg_d, float(f(1.0) - th * th)) / (
        hg_d * torch.sqrt(hg_d))
    mu_ic = torch.clamp(mu_i, 1e-6, 1.0)
    t_i = torch.sqrt(torch.clamp(1.0 - mu_ic * mu_ic, min=0.0)) / mu_ic
    t_r = torch.sqrt(torch.clamp(1.0 - mu_r * mu_r, min=0.0)) / mu_r
    cap_g = torch.sqrt(torch.clamp(
        (t_i * t_i + t_r * t_r) - ((2.0 * t_i) * t_r) * cos_dphi, min=0.0))
    hot = 1.0 + torch.full_like(cap_g, float(f(1.0) - rho0)) / (1.0 + cap_g)
    return ((float(rho0) * minnaert) * hg_l) * hot


@dataclasses.dataclass(frozen=True)
class RecordTally:
    """What a launch adds into: ``acc`` the flux tally [prm.n_acc] f32,
    ``img`` the radiance tally [max(1, prm.n_img)] f32, ``exc`` the capped
    excess [max(1, prm.n_exc)] f32, ``counts`` int32 [photons started,
    lanes with work left, lane-steps run with a live photon, real
    collisions, radiance marches cut by the iteration bound, local-estimate
    events] (``relaunch_loop`` layout, the first four per launch) and
    ``march`` int64 [1] the local estimate's march iterations."""

    acc: torch.Tensor
    img: torch.Tensor
    exc: torch.Tensor
    counts: torch.Tensor
    march: torch.Tensor

    @staticmethod
    def zeros(prm: RecordParams, device) -> "RecordTally":
        def z(n, dtype=torch.float32):
            return torch.zeros(max(1, n), dtype=dtype, device=device)

        return RecordTally(acc=z(prm.n_acc), img=z(prm.n_img),
                           exc=z(prm.n_exc), counts=z(N_COUNTS, torch.int32),
                           march=z(1, torch.int64))


def record_step_plain(st: RecordState, tab: RecordTables, prm: RecordParams,
                      lane: torch.Tensor, seed: int, ctr: int,
                      tally: RecordTally) -> torch.Tensor:
    """One transport step for every lane; returns the photons started.

    ``lane`` holds the int64 lane indices, ``ctr`` the step counter;
    ``tally`` receives this step's flux (and radiance) tallies. Operation
    for operation the JAX kernel's float32 arithmetic (pallas_kernel.py
    _build_kernel)."""
    acc = tally.acc
    p = prm
    u = rng.make_uniform(lane, seed)
    x0, lx, y0, ly = p[P_X0], p[P_LX], p[P_Y0], p[P_LY]
    z0, z_max, beta_max = p[P_Z0], p[P_ZMAX], p[P_BETA_MAX]
    nx, ny, nz = p.nx, p.ny, p.nz
    nxy = nx * ny
    macro = p.macro_factor > 0
    x, y, z, ux, uy, uz, w, bl = (st.x, st.y, st.z, st.ux, st.uy, st.uz,
                                  st.w, st.bl)

    # ---- refill dead lanes from the source (pallas_kernel.py:897-1027) ----
    alive = st.alive > 0
    need = ~alive & (st.quota > 0)
    kind = SOURCE_KINDS[p.source_kind]
    if kind == illumination.EMISSION:
        ex, ey, ez, s_mu, from_atm, birth = emission_refill(u, ctr, tab, p)
        x = torch.where(need, ex, x)
        y = torch.where(need, ey, y)
        z = torch.where(need, ez, z)
    else:
        if kind == illumination.SPOTLIGHT:  # one entry point
            x = torch.where(
                need, float(_F32(x0) + _F32(p[P_SPOT_X]) * _F32(lx)), x)
            y = torch.where(
                need, float(_F32(y0) + _F32(p[P_SPOT_Y]) * _F32(ly)), y)
        else:
            x = torch.where(need, x0 + u(ctr, rng.SITE_X) * lx, x)
            y = torch.where(need, y0 + u(ctr, rng.SITE_Y) * ly, y)
        z = torch.where(need, p[P_ZTOP], z)
    if kind in (illumination.DIRECTIONAL, illumination.SPOTLIGHT):
        s_mu = torch.full_like(x, -p[P_SMU])
        sux = torch.full_like(x, p[P_SUX])
        suy = torch.full_like(x, p[P_SUY])
    else:
        if kind == illumination.RANDOM_AZIMUTH:
            s_mu = torch.full_like(x, -p[P_SMU])
            s_phi = p[P_TWO_PI] * u(ctr, rng.SITE_SOURCE)
        elif kind == illumination.FLUX:  # mu = -sqrt(u)
            s_mu = -torch.sqrt(torch.clamp(u(ctr, rng.SITE_SOURCE),
                                           min=1e-12))
            s_phi = p[P_TWO_PI] * u(ctr, rng.SITE_SOURCE_PHI)
        else:  # emission: mu from the refill; the azimuth as flux's
            s_phi = p[P_TWO_PI] * u(ctr, rng.SITE_SOURCE_PHI)
        s_sin = torch.sqrt(torch.clamp(1.0 - s_mu * s_mu, min=0.0))
        sux = s_sin * torch.cos(s_phi)
        suy = s_sin * torch.sin(s_phi)
    ux = torch.where(need, sux, ux)
    uy = torch.where(need, suy, uy)
    uz = torch.where(need, s_mu, uz)
    w = torch.where(need, 1.0, w)
    alive = alive | need
    quota = st.quota - need.to(torch.int32)
    started = need.sum()
    tally.counts[2] += alive.sum().to(torch.int32)
    # LW radiance: a newly emitted photon contributes its emission local
    # estimate this step and moves from the next one (pallas_kernel.py:986)
    held = need if p.lw and p.n_dirs > 0 else None

    # ---- Woodcock jump ----
    tau = -torch.log1p(-u(ctr, rng.SITE_TAU))
    if macro:
        bl = torch.where(need, beta_max, bl)
        t_raw = torch.minimum(
            face_distance(x, x0, ux, p[P_BXW], lx),
            torch.minimum(face_distance(y, y0, uy, p[P_BYW], ly),
                          face_distance(z, z0, uz, p[P_BZW], p[P_LZ])))
        escape = t_raw <= 0.0
        bl = torch.where(escape, beta_max, bl)
        d_samp = torch.where(bl > 0, tau / torch.where(bl == 0, 1.0, bl),
                             3e38)
        t_clip = torch.where(escape, 3e38, t_raw + p[P_NUDGE])
        clipped = t_clip < d_samp
        d = torch.minimum(d_samp, t_clip)
    else:
        d = tau * p[P_INV_BETA_MAX]
        clipped = torch.zeros_like(alive)
    zn = z + uz * d
    exit_top = alive & (zn >= z_max)
    exit_bot = alive & ~exit_top & (zn <= z0)
    moved = alive & ~exit_top & ~exit_bot
    collide = moved & ~clipped
    if held is not None:  # held lanes neither move nor tally this step
        exit_top = exit_top & ~held
        exit_bot = exit_bot & ~held
        moved = moved & ~held
        collide = collide & ~held

    # boundary crossing point (exit tallies + reflection)
    z_b = torch.where(exit_top, z_max, z0)
    t_b = (z_b - z) / torch.where(uz.abs() < 1e-12, 1.0, uz)
    xe = x0 + torch.remainder((x + ux * t_b) - x0, lx)
    ye = y0 + torch.remainder((y + uy * t_b) - y0, ly)
    ixe = ((xe - x0) * p[P_INV_DX]).to(torch.int32).clamp(0, nx - 1)
    iye = ((ye - y0) * p[P_INV_DY]).to(torch.int32).clamp(0, ny - 1)
    col_e = ixe * ny + iye

    # collision (or macro-face) point and cell
    xc = x0 + torch.remainder((x + ux * d) - x0, lx)
    yc = y0 + torch.remainder((y + uy * d) - y0, ly)
    zc = torch.clamp(zn, z0, z_max)
    ix = ((xc - x0) * p[P_INV_DX]).to(torch.int32).clamp(0, nx - 1)
    iy = ((yc - y0) * p[P_INV_DY]).to(torch.int32).clamp(0, ny - 1)
    iz = ((zc - z0) * p[P_INV_DZ]).to(torch.int32).clamp(0, nz - 1)
    col_c = ix * ny + iy
    cell = torch.where(moved if macro else collide, col_c * nz + iz, 0)

    u_ang = u(ctr, rng.SITE_ANGLE)
    phi_rot = p[P_TWO_PI] * u(ctr, rng.SITE_AZIMUTH)
    exits = exit_top | exit_bot

    # ---- record fetch ----
    rec = tab.records[cell.long()]
    beta = rec[:, 0]
    ssa = rec[:, p.off_ssa]
    f2 = rec[:, p.off_f2]
    # local-estimate slot of a scatter (0 is the surface's)
    slot_sc = torch.ones_like(cell, dtype=torch.int64)
    if p.ncomp > 1:
        # one uniform picks the scattering component against the cell's
        # cumulative scattering fractions (pallas_kernel.py:1296-1309)
        u_cmp = u(ctr, rng.SITE_COMPONENT)
        past0 = u_cmp >= rec[:, 3]
        f2 = torch.where(past0, rec[:, 6], f2)
        slot_sc = slot_sc + past0.to(torch.int64)
        if p.ncomp == 3:
            past1 = u_cmp >= rec[:, 4]
            f2 = torch.where(past1, rec[:, 7], f2)
            slot_sc = slot_sc + past1.to(torch.int64)
    # null-collision test against the majorant this step sampled with,
    # then carry the destination block's majorant
    ceiling = bl if macro else beta_max
    real = collide & (u(ctr, rng.SITE_COLLIDE) * ceiling < beta)
    tally.counts[3] += real.sum().to(torch.int32)
    if macro:
        bl = torch.where(moved, rec[:, 1], bl)
    absorbed = torch.where(real, w * (1.0 - ssa), 0.0)
    w = torch.where(real, w * ssa, w)
    # the local estimate takes the post-absorption, pre-roulette weight and
    # the incoming direction (pallas_kernel.py:1317-1322)
    w_int, ux_in, uy_in, uz_in = w, ux, uy, uz

    # ---- Russian roulette ----
    if p.use_rr:
        rr_w = p[P_RR_W]
        play = real & (w < p[P_HALF_RR])
        survive = u(ctr, rng.SITE_ROULETTE) < div_scalar(w, rr_w)
        w = torch.where(play, torch.where(survive, rr_w, 0.0), w)
    died_weight = real & (w <= _TINY)

    # ---- scattering ----
    scatter = real & ~died_weight
    if p.analytic_hg:
        cos_t = sample_hg_cos(f2, u_ang)
    else:
        n_steps = p.inv_n_steps
        t_u = u_ang * float(n_steps - 1)
        k = t_u.to(torch.int32).clamp(0, n_steps - 2)
        frac = t_u - k.to(torch.float32)
        flat = (f2.to(torch.int32) * n_steps + k).long()
        cos_t = torch.cos(tab.inv_a0[flat] + frac * tab.inv_dd[flat])
    ox, oy, oz = rotate_direction(ux, uy, uz, cos_t, phi_rot)
    ux = torch.where(scatter, ox, ux)
    uy = torch.where(scatter, oy, uy)
    uz = torch.where(scatter, oz, uz)

    # ---- surface reflection (pallas_kernel.py:1436-1498): ux, uy, uz
    # still hold the incoming direction of the lanes that reach it ----
    w_down = w
    mu_new = torch.sqrt(torch.clamp(u_ang, min=1e-12))
    sin_new = torch.sqrt(torch.clamp(1.0 - mu_new * mu_new, min=0.0))
    cos_phi, sin_phi = torch.cos(phi_rot), torch.sin(phi_rot)
    if p.surface == SURF_RPV:
        w_refl = w_down * rpv_weight(p[P_ALBEDO], p[P_RPV_K], p[P_RPV_TH],
                                     ux, uy, uz, mu_new, sin_new, cos_phi,
                                     sin_phi)
    elif p.surface == SURF_PX:  # the albedo of the landing column
        w_refl = w_down * tab.albedo[col_e.long()]
    else:
        w_refl = w_down * p[P_ALBEDO]
    died_surface = exit_bot & (w_refl <= _TINY)
    reflected = exit_bot & ~died_surface
    x = torch.where(exit_bot, xe, torch.where(moved, xc, x))
    y = torch.where(exit_bot, ye, torch.where(moved, yc, y))
    z = torch.where(exit_bot, p[P_ZBOT], torch.where(moved, zc, z))
    ux = torch.where(reflected, sin_new * cos_phi, ux)
    uy = torch.where(reflected, sin_new * sin_phi, uy)
    uz = torch.where(reflected, mu_new, uz)
    w = torch.where(reflected, w_refl, w)
    if macro:
        bl = torch.where(exit_bot, beta_max, bl)
    alive = alive & ~exit_top & ~died_weight & ~died_surface

    # ---- local estimate: scatters at the collision point, reflections
    # just above the surface, emissions at the birth point (disjoint per
    # lane; pallas_kernel.py:1523-1534, :1682-1688) ----
    if p.n_dirs > 0:
        ev_kind = torch.where(reflected, EV_LAMBERT, EV_SCATTER)
        sx = torch.where(reflected, xe, xc)
        sy = torch.where(reflected, ye, yc)
        sz = torch.where(reflected, p[P_ZBOT], zc)
        w_ev = torch.where(reflected, w_refl, w_int)
        event = real | reflected
        if held is not None:
            event = event | held
            ev_kind = torch.where(
                held, torch.where(from_atm, EV_ISOTROPIC, EV_LAMBERT),
                ev_kind)
            sx = torch.where(held, x, sx)
            sy = torch.where(held, y, sy)
            sz = torch.where(held, z, sz)
            w_ev = torch.where(held, 1.0, w_ev)
        ev = torch.nonzero(event).squeeze(1)
        if ev.numel():
            # capped-excess slot: 0 for reflections and emissions
            local_estimate_plain(
                tab, prm, u, ctr, ev, ev_kind[ev],
                torch.where(real[ev], slot_sc[ev], 0), sx[ev], sy[ev],
                sz[ev], w_ev[ev], ux_in[ev], uy_in[ev], uz_in[ev], f2[ev],
                tally)

    # ---- fused tally: one entry per lane (exit or absorption) ----
    t_val = torch.where(exit_top, w, torch.where(exit_bot, w_down, absorbed))
    t_val = torch.where(exits | real, t_val, 0.0)
    t_idx = torch.where(exits, torch.where(exit_top, col_e, nxy + col_e),
                        2 * nxy + (cell if p.vol_tally else col_c))
    acc.index_add_(0, t_idx.long(), t_val)
    if p.lw:
        # LW pre-credit: -1 at the birth cell of every atmospheric emission,
        # the lane's second tally this step (pallas_kernel.py:2189-2213)
        atm_emit = need & from_atm
        acc.index_add_(0, (2 * nxy + birth[atm_emit]).long(),
                       torch.full_like(x[atm_emit], -1.0))

    st.x, st.y, st.z, st.ux, st.uy, st.uz, st.w, st.bl = (
        x, y, z, ux, uy, uz, w, bl)
    st.quota = quota
    st.alive = alive.to(torch.int32)
    return started


def local_estimate_plain(tab: RecordTables, prm: RecordParams, u, ctr: int,
                         ev: torch.Tensor, ev_kind: torch.Tensor,
                         slot: torch.Tensor,
                         sx, sy, sz, w_ev, ux_in, uy_in, uz_in, f2,
                         tally: RecordTally) -> None:
    """Local estimate of the event lanes ``ev`` (int64 lane indices; the
    other arguments are per event) toward every direction, tallied into
    ``tally.img`` / ``tally.exc``; marches cut by the iteration bound are
    counted into ``tally.counts[4]``, the events into ``tally.counts[5]``
    and the march iterations into ``tally.march``. ``ev_kind`` (EV_*) picks the phase
    term; ``slot`` is the capped-excess slot of each event (0 a reflection
    or an emission, 1 + c a scatter by component c).

    Same float32 arithmetic as pallas_kernel.py:1515-2084 with the cell
    march: all (event, direction) pairs march together, each until it
    leaves the top (or, with roulette, passes its stopping depth)."""
    p = prm
    nx, ny, nz, nxy, n_dirs = p.nx, p.ny, p.nz, p.nx * p.ny, p.n_dirs
    x0, lx, y0, ly, z0 = p[P_X0], p[P_LX], p[P_Y0], p[P_LY], p[P_Z0]
    z_max, inv_dx, inv_dy = p[P_ZMAX], p[P_INV_DX], p[P_INV_DY]
    inv_dz, dxc, dyc, dzc = p[P_INV_DZ], p[P_DXC], p[P_DYC], p[P_DZC]
    n_ev = ev.shape[0]
    tally.counts[5] += n_ev

    def pairs(v):  # per event -> per (event, direction), event-major
        return v.repeat_interleave(n_dirs)

    d_idx = torch.arange(n_dirs, device=ev.device).repeat(n_ev)
    ddx, ddy, ddz = (tab.dirs[i][d_idx] for i in range(3))
    kind_p = pairs(ev_kind)
    cosb = (pairs(ux_in) * ddx + pairs(uy_in) * ddy) + pairs(uz_in) * ddz
    if p.le_phase == PHASE_HG:
        g = pairs(f2)
        q = torch.clamp((1.0 + g * g) - (2.0 * g) * cosb, min=1e-12)
        pv = (1.0 - g * g) / (q * torch.sqrt(q))
    else:
        # table uniform in s = sin(theta/2): the index needs a sqrt only
        s_v = torch.sqrt(torch.clamp((1.0 - cosb) * 0.5, min=0.0))
        tpos = s_v * float(FWD_N_S - 1)
        k_f = tpos.to(torch.int32).clamp(0, FWD_N_S - 2)
        frac = tpos - k_f.to(torch.float32)
        flat = k_f.long()
        if p.le_phase == PHASE_TABLE:
            flat = flat + pairs(f2).to(torch.int64) * FWD_N_S
        pv = tab.fwd_v0[flat] + frac * tab.fwd_dd[flat]
    four_pi_mu = float(_F32(4.0 * np.pi)) * ddz
    npf = torch.where(kind_p == EV_LAMBERT, float(_F32(1.0 / np.pi)),
                      pv / four_pi_mu)
    npf = torch.where(kind_p == EV_ISOTROPIC,
                      torch.ones_like(ddz) / four_pi_mu, npf)
    sdx = torch.where(ddx.abs() > 1e-12, ddx, 1e-12)
    sdy = torch.where(ddy.abs() > 1e-12, ddy, 1e-12)
    ndx, ndy = torch.sign(ddx) * 1e-4, torch.sign(ddy) * 1e-4
    if p.le_rr:
        # Iwabuchi roulette draws, sites 16 + 2d and 17 + 2d
        lane_p = pairs(ev)
        u_i1 = u(ctr, 16 + 2 * d_idx, lane_p)
        tau_free = -torch.log1p(-u(ctr, 17 + 2 * d_idx, lane_p))
        zeta = p[P_ZETA]
        npf_pi = float(_F32(np.pi)) * npf
        small = npf_pi <= zeta
        tau_max = -torch.log(zeta / torch.clamp(npf_pi, min=_TINY))
        tau_stop = torch.where(small, tau_free, tau_max + tau_free)

    px, py, pz = pairs(sx), pairs(sy), pairs(sz)
    tau = torch.zeros_like(px)
    ex_col = torch.zeros(px.shape, dtype=torch.int64, device=px.device)
    act = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    n_march = 0
    for _ in range(p.k_dda):
        if not bool(act.any()):
            break
        n_march += int(act.sum())
        pxw = x0 + torch.remainder(px - x0, lx)
        pyw = y0 + torch.remainder(py - y0, ly)
        # index-space nudge along the march: a face landing names the
        # cell being entered for either direction sign
        ixm = ((pxw - x0) * inv_dx + ndx).to(torch.int32).clamp(0, nx - 1)
        iym = ((pyw - y0) * inv_dy + ndy).to(torch.int32).clamp(0, ny - 1)
        izm = ((pz - z0) * inv_dz).to(torch.int32).clamp(0, nz - 1)
        beta_m = tab.records[((ixm * ny + iym) * nz + izm).long(), 0]
        fx = torch.where(ddx >= 0, ixm + 1, ixm).to(torch.float32) * dxc + x0
        fy = torch.where(ddy >= 0, iym + 1, iym).to(torch.float32) * dyc + y0
        fz = (izm + 1).to(torch.float32) * dzc + z0
        tx = torch.where(ddx.abs() > 1e-12, (fx - pxw) / sdx, 3e38)
        ty = torch.where(ddy.abs() > 1e-12, (fy - pyw) / sdy, 3e38)
        tz = (fz - pz) / ddz
        ds = torch.clamp(torch.minimum(tx, torch.minimum(ty, tz)),
                         min=0.0) + p[P_MNUDGE]
        tau = torch.where(act, tau + beta_m * ds, tau)
        pz2 = pz + ddz * ds
        top = pz2 >= z_max
        tb = (z_max - pz) / ddz
        exx = x0 + torch.remainder((pxw + ddx * tb) - x0, lx)
        exy = y0 + torch.remainder((pyw + ddy * tb) - y0, ly)
        exc = (((exx - x0) * inv_dx).to(torch.int32).clamp(0, nx - 1) * ny
               + ((exy - y0) * inv_dy).to(torch.int32).clamp(0, ny - 1))
        ex_col = torch.where(act & top, exc.long(), ex_col)
        act = act & ~top
        if p.le_rr:
            act = act & (tau < tau_stop)
        px, py, pz = pxw + ddx * ds, pyw + ddy * ds, pz2
    tally.counts[4] += act.sum().to(torch.int32)
    tally.march.add_(n_march)
    hit = ~act
    w_p = pairs(w_ev)
    if p.le_rr:
        w_rrc = (w_p * zeta) * float(_F32(1.0 / np.pi))
        c_a = torch.where(hit & (tau < tau_free) & (u_i1 * zeta <= npf_pi),
                          w_rrc, 0.0)
        c_b = torch.where(hit & (tau < tau_max),
                          (w_p * npf) * torch.exp(-tau),
                          torch.where(hit & (tau - tau_max < tau_free),
                                      w_rrc, 0.0))
        contrib = torch.where(small, c_a, c_b)
    else:
        contrib = torch.where(hit, (w_p * npf) * torch.exp(-tau), 0.0)
    if p.le_cap:
        cap = p[P_MAXC]
        over = torch.clamp(contrib - cap, min=0.0)
        contrib = torch.clamp(contrib, max=cap)
        slot_p = pairs(slot)
        tally.exc.index_add_(0, slot_p * n_dirs + d_idx, over)
        tally.img.index_add_(0, (slot_p * n_dirs + d_idx) * nxy + ex_col,
                             contrib)
    else:
        tally.img.index_add_(0, d_idx * nxy + ex_col, contrib)


def record_launch_plain(st: RecordState, tab: RecordTables,
                        prm: RecordParams, seed: int, step0: int,
                        k_steps: int, tally: RecordTally) -> None:
    """``k_steps`` plain steps; adds [started, lanes with work left,
    lane-steps, real collisions, cut marches] into ``tally.counts`` -- the
    contract of one kernel launch."""
    lane = torch.arange(st.x.shape[0], dtype=torch.int64, device=st.x.device)
    started = torch.zeros((), dtype=torch.int64, device=st.x.device)
    for k in range(k_steps):
        started = started + record_step_plain(st, tab, prm, lane, seed,
                                              step0 + k, tally)
    work = ((st.alive > 0) | (st.quota > 0)).sum()
    tally.counts[:2] += torch.stack([started, work]).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32


def _library():
    from mcbrat3d_tpu_torch import _build
    lib = _build.load("record_kernel")
    if not getattr(lib, "_mcb_typed", False):
        lib.record_kernel_num_params.restype = _I
        lib.record_kernel_num_params.argtypes = []
        lib.record_kernel_launch.restype = _I
        lib.record_kernel_launch.argtypes = (
            [_P] * 25 + [_I] * 10 + [_U, _U] + [_I] * 8 + [_I] * 8 + [_P])
        if lib.record_kernel_num_params() != N_PARAMS:
            raise RuntimeError("csrc/record_kernel.cu and record_kernel.py "
                               "disagree on the parameter layout")
        lib._mcb_typed = True
    return lib


def _check(t: torch.Tensor, name: str, dtype, n: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor of {n} "
                         f"elements, got shape {tuple(t.shape)}")


def _launch_cuda(st: RecordState, tab: RecordTables, prm: RecordParams,
                 seed: int, step0: int, k_steps: int,
                 tally: RecordTally) -> None:
    global LAUNCHES, RADIANCE_LAUNCHES, LW_LAUNCHES, RPV_LAUNCHES, PX_LAUNCHES
    dev = st.x.device
    n = st.x.shape[0]
    for name in RecordState.FLOAT_FIELDS:
        _check(getattr(st, name), name, torch.float32, n, dev)
    for name in RecordState.INT_FIELDS:
        _check(getattr(st, name), name, torch.int32, n, dev)
    n_cells = prm.nx * prm.ny * prm.nz
    _check(tab.records, "records", torch.float32, n_cells * prm.stride, dev)
    if prm.ncomp > 1 and tab.records.data_ptr() % 16:
        raise ValueError("multi-component records must be 16-byte aligned "
                         "(the kernel reads them as float4)")
    _check(tab.inv_a0, "inv_a0", torch.float32, tab.inv_a0.numel(), dev)
    _check(tab.inv_dd, "inv_dd", torch.float32, tab.inv_a0.numel(), dev)
    _check(prm.device_values, "params", torch.float32, N_PARAMS, dev)
    _check(tally.acc, "acc", torch.float32, prm.n_acc, dev)
    _check(tally.img, "img", torch.float32, max(1, prm.n_img), dev)
    _check(tally.exc, "exc", torch.float32, max(1, prm.n_exc), dev)
    _check(tally.counts, "counts", torch.int32, N_COUNTS, dev)
    _check(tally.march, "march", torch.int64, 1, dev)
    emission = SOURCE_KINDS[prm.source_kind] == illumination.EMISSION
    if emission:
        _check(tab.em_prob, "em_prob", torch.float32, n_cells, dev)
        _check(tab.em_alias, "em_alias", torch.float32, n_cells, dev)
    if prm.surface == SURF_PX:
        _check(tab.albedo, "albedo", torch.float32, prm.nx * prm.ny, dev)
    if prm.n_dirs:
        if prm.n_dirs > le.MAX_KERNEL_DIRS:
            raise ValueError(f"{prm.n_dirs} radiance directions > "
                             f"{le.MAX_KERNEL_DIRS} per launch")
        _check(tab.dirs, "dirs", torch.float32, 3 * prm.n_dirs, dev)
        if prm.le_phase != PHASE_HG:
            _check(tab.fwd_v0, "fwd_v0", torch.float32, tab.fwd_v0.numel(),
                   dev)
            _check(tab.fwd_dd, "fwd_dd", torch.float32, tab.fwd_v0.numel(),
                   dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [prm.device_values, tab.records, tab.inv_a0, tab.inv_dd,
            *(getattr(st, k) for k in RecordState.FLOAT_FIELDS),
            st.quota, st.alive, tally.acc, tally.counts, tab.dirs,
            tab.fwd_v0, tab.fwd_dd, tally.img, tally.exc, tab.em_prob,
            tab.em_alias, tab.albedo, tally.march]
    err = lib.record_kernel_launch(
        *(t.data_ptr() for t in ptrs), n, prm.nx, prm.ny, prm.nz,
        prm.stride, prm.off_ssa, prm.off_f2, prm.inv_n_steps,
        int(prm.use_rr), prm.n_acc, seed & 0xFFFF_FFFF,
        step0 & 0xFFFF_FFFF, k_steps, int(prm.macro_factor > 0),
        int(prm.vol_tally), int(prm.analytic_hg), prm.source_kind,
        prm.ncomp, int(prm.lw), prm.surface, prm.n_dirs, prm.le_phase,
        FWD_N_S, int(prm.le_rr), int(prm.le_cap), prm.k_dda, prm.n_img,
        prm.n_exc, stream)
    LAUNCHES += 1
    if prm.n_dirs:
        RADIANCE_LAUNCHES += 1
    if emission:
        LW_LAUNCHES += 1
    RPV_LAUNCHES += int(prm.surface == SURF_RPV)
    PX_LAUNCHES += int(prm.surface == SURF_PX)
    if err != 0:
        raise RuntimeError(f"record_kernel launch failed: CUDA error {err}")


def record_launch(st: RecordState, tab: RecordTables, prm: RecordParams,
                  seed: int, step0: int, k_steps: int,
                  tally: RecordTally) -> None:
    """Advance every lane by ``k_steps`` steps: the CUDA kernel for state on
    a CUDA device, the plain PyTorch step for state on the CPU."""
    if st.x.is_cuda:
        _launch_cuda(st, tab, prm, seed, step0, k_steps, tally)
    elif st.x.device.type == "cpu":
        record_launch_plain(st, tab, prm, seed, step0, k_steps, tally)
    else:
        raise ValueError(f"no record kernel for device {st.x.device}")


# ---------------------------------------------------------------------------
# Relaunch loop
# ---------------------------------------------------------------------------

def relaunch_loop(st, counts: torch.Tensor, launch_steps,
                  steps_per_call: int, max_steps: int,
                  n_per_launch: int = 3) -> tuple:
    """The host loop around a transport kernel, shared by the record and
    column kernels (``run_batch_pallas`` / ``run_batch_pallas_col``):
    ``launch_steps(step0)`` advances every lane by ``steps_per_call``
    steps from step ``step0``; after each launch the photons started and
    the lanes with work left are read back, the unspent quota is
    rebalanced evenly over the lanes, and the loop stops when no work is
    left or at ``max_steps``.

    ``st`` is the state (its int32 ``quota`` is rebound), ``counts`` the
    int32 launch counters [started, work left, lane-steps with a live
    photon, real collisions (``n_per_launch`` = 4), ...]; the first
    ``n_per_launch`` are zeroed before each launch, so none overflows.
    Returns (photons started, launches, lane-steps with a live photon,
    real collisions or 0)."""
    n_lanes = st.quota.shape[0]
    lane_i = torch.arange(n_lanes, dtype=torch.int32, device=st.quota.device)
    n_started = n_calls = lane_steps = n_real = 0
    work = True
    while work and n_calls * steps_per_call < max_steps:
        counts[:n_per_launch] = 0
        launch_steps(n_calls * steps_per_call)
        started, work_left, steps, *real = counts[:n_per_launch].tolist()
        n_started += started
        lane_steps += steps
        n_real += sum(real)
        work = work_left > 0
        # any lane may run any photon: streams are keyed by (lane, step)
        total_q = st.quota.sum()
        st.quota = (total_q // n_lanes
                    + (lane_i < total_q % n_lanes)).to(torch.int32)
        n_calls += 1
    return n_started, n_calls, lane_steps, n_real


def initial_quota(n_lanes: int, photons_per_lane: int, n_photons,
                  device) -> torch.Tensor:
    """Per-lane photon quota of a batch: ``photons_per_lane`` each, or
    ``n_photons`` (clamped to the lanes' budget) spread evenly, the first
    ``n_photons % n_lanes`` lanes taking one more (the exact n_photons
    clamp of pallas_kernel.py / pallas_col.py:1363-1371)."""
    if n_lanes * photons_per_lane >= 2 ** 31:
        raise ValueError(
            f"n_lanes*photons_per_lane = {n_lanes * photons_per_lane} "
            f"overflows the int32 quota budget; split into more batches")
    if n_photons is None:
        return torch.full((n_lanes,), photons_per_lane, dtype=torch.int32,
                          device=device)
    lane_i = torch.arange(n_lanes, dtype=torch.int32, device=device)
    n_ph = min(int(n_photons), n_lanes * photons_per_lane)
    return (n_ph // n_lanes + (lane_i < n_ph % n_lanes)).to(torch.int32)


def _record_batch(domain, surface, source, seed, rcfg, photons_per_lane,
                  n_photons, use_russian_roulette, russian_roulette_weight,
                  launch, intensity_config, intensity_dirs, lw_mode):
    """``run_batch_record``'s tuple, the lane-steps with a live photon, the
    real collisions and the local estimate's (events, march
    iterations)."""
    dev = domain.device
    prm = RecordParams.make(domain, surface, source, use_russian_roulette,
                            russian_roulette_weight, rcfg.vol_tally,
                            intensity_config, intensity_dirs, lw_mode)
    tab = RecordTables.from_domain(domain, intensity_config, intensity_dirs,
                                   source, surface)
    quota0 = initial_quota(rcfg.n_lanes, photons_per_lane, n_photons, dev)
    st = RecordState.initial(quota0, prm[P_BETA_MAX])
    tally = RecordTally.zeros(prm, dev)
    k = rcfg.steps_per_call
    n_started, n_calls, lane_steps, n_real = relaunch_loop(
        st, tally.counts,
        lambda step0: launch(st, tab, prm, seed, step0, k, tally),
        k, rcfg.max_steps, n_per_launch=4)
    nx, ny, nz = domain.grid.shape
    nxy = nx * ny
    acc = tally.acc
    flux_up = acc[:nxy].reshape(nx, ny)
    flux_down = acc[nxy:2 * nxy].reshape(nx, ny)
    absorbed = acc[2 * nxy:].reshape((nx, ny, nz) if rcfg.vol_tally
                                     else (nx, ny))
    n_cut = int(tally.counts[4])
    n_bad = int(st.alive.sum()) + n_cut
    out = (flux_up, flux_down, absorbed, n_started, n_bad, n_calls)
    le_counts = (int(tally.counts[5]), int(tally.march))
    if not prm.n_dirs:
        return out, lane_steps, n_real, le_counts
    img = tally.img[:prm.n_img].reshape(prm.n_sec, prm.n_dirs, nxy)
    if prm.le_cap:
        excess = tally.exc.reshape(prm.n_sec, prm.n_dirs).T
        image = le.redistribute_excess(img.sum(dim=0), img, excess)
    else:
        image = img[0]
    return (out + (image.T.reshape(nx, ny, prm.n_dirs), n_cut), lane_steps,
            n_real, le_counts)


def run_batch_record(domain: OpticalDomain, surface: Surface,
                     source: illumination.Source, seed: int,
                     rcfg: RecordConfig, photons_per_lane: int,
                     n_photons=None, use_russian_roulette: bool = True,
                     russian_roulette_weight: float = 1.0,
                     launch=record_launch, intensity_config=None,
                     intensity_dirs=None, lw_mode: bool = False):
    """Run one photon batch; returns (flux_up [nx,ny], flux_down [nx,ny],
    absorbed ([nx,ny,nz] with ``rcfg.vol_tally``, else [nx,ny]),
    n_started, n_bad, n_calls), plus the raw radiance image
    [nx, ny, n_dirs] and the count of cut marches when
    ``intensity_config`` is given.

    Port of ``run_batch_pallas`` + ``_make_launch`` around
    ``relaunch_loop``. ``n_bad`` counts photons still alive at the step cap
    plus radiance marches cut by the iteration bound. ``seed`` is the
    uint32 kernel seed; ``launch`` is ``record_launch`` (or, to compare the
    two on one device, ``record_launch_plain``). With capping the excess is
    redistributed over the image after the batch
    (pallas_kernel.py:3014-3033). ``lw_mode`` with an emission source
    pre-credits the births (needs ``rcfg.vol_tally``)."""
    return _record_batch(domain, surface, source, seed, rcfg,
                         photons_per_lane, n_photons, use_russian_roulette,
                         russian_roulette_weight, launch, intensity_config,
                         intensity_dirs, lw_mode)[0]


def run_batch_record_tallies(domain, surface, source, seed: int, config,
                             n_photons=None, launch=record_launch,
                             intensity_config=None, intensity_dirs=None,
                             radiance_rows: int = RADIANCE_ROWS):
    """``run_batch``-compatible entry (port of ``run_batch_pallas_tallies``):
    returns a ``transport.integrator.Tallies``. A radiance run uses at most
    ``radiance_rows`` rows of 128 lanes and folds the rest of the batch
    into per-lane quota (pallas_kernel.py:3278-3291)."""
    # absorption per column unless the 3D field or its profile is wanted,
    # or lw_mode pre-credits the births (pallas_kernel.py:3272-3277)
    vol = (config.need_volume_absorption or config.need_absorption_profile
           or config.lw_mode)
    rcfg, ppl = config_for(config.n_lanes, config.photons_per_lane,
                           config.max_steps, vol_tally=vol)
    if intensity_config is not None:
        rows = min(rcfg.rows, radiance_rows)
        ppl = -(-config.photons_per_batch // (rows * LANES_PER_ROW))
        rcfg = dataclasses.replace(rcfg, rows=rows)
    if n_photons is None:
        n_photons = config.photons_per_batch
    out, lane_steps, n_real, (n_events, n_march) = _record_batch(
        domain, surface, source, seed, rcfg, ppl, n_photons,
        config.use_russian_roulette, config.russian_roulette_weight,
        launch, intensity_config, intensity_dirs, config.lw_mode)
    fu, fd, ab, n_started, n_bad, n_calls = out[:6]
    return Tallies(
        flux_up=fu, flux_down=fd,
        flux_absorbed=ab.sum(dim=2) if vol else ab,
        volume_absorption=ab if vol else None,
        intensity=out[6] if len(out) > 6 else None,
        n_photons=n_started, n_bad=n_bad,
        n_cut=out[7] if len(out) > 6 else 0,
        n_steps=n_calls * rcfg.steps_per_call, n_lane_steps=lane_steps,
        n_real=n_real, n_le_events=n_events, n_walk=n_march)
