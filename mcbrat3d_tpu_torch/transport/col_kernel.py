"""Column-template kernel (K3): the CUDA kernel, its plain PyTorch step and
the batch entry points, for the flux path, the gas template and the local
estimate of top-of-domain radiances.

PyTorch counterpart of ``mcbrat3d_tpu.transport.pallas_col``
(``pallas_col_eligible``, ``col_intensity_ineligibility_reasons``,
``plan_col_march``'s direction order, ``_build_kernel_col``,
``run_batch_pallas_col``, ``run_batch_pallas_col_tallies``) for
Landsat-scale domains whose extinction is a column template,

    beta(x, y, z) = col_scale[col] * (iz < col_height[col]) [+ col_qz[iz]],

so two per-column values (at most 16,384 columns) carry a field of
millions of cells. Every lane (slot) carries one photon at a time through
``steps_per_call`` steps per launch: refill from a directional,
random-azimuth or flux source or from the domain's thermal emission; a
Woodcock jump against the carried xy-block majorant below the
block's cloud-top plane and a geometric advance above it, clipped at the
block faces (clamped to the domain edge) and, descending, at the plane; the
column gather; the null-collision test; absorption by the uniform ssa;
Russian roulette; analytic HG or single-row inverse-CDF scattering;
Lambertian reflection, off a uniform albedo or a per-pixel albedo grid
read at the exit column; and the tallies of flux up/down and absorption per
column, the absorption z profile and, optionally, the 3D absorption field.

The gas template (two components, ``domain.col_qz``: a cloud of that shape
over a horizontally uniform pure absorber, pallas_col.py:507-513,
:604-611, :630-641) adds the gas maximum ``qg`` to the ceiling (above the
block's plane the photon samples against ``qg`` instead of advancing
geometrically) and ``col_qz[iz]`` to the collision's extinction, and
absorbs by the cell's effective ssa ``beta_cloud * ssa / beta``.

Column BBEmission (pallas_col.py:407-466, one component with uniform ssa,
the domain's ``col_em_*`` tables): a share ``atms_fraction`` of the
photons start in the atmosphere, in the column a Walker alias draw over the
columns picks and at the level found by inverting the cumulative Planck
table truncated at that column's height, with an isotropic mu of magnitude
at least 1e-4; the rest start on the surface with mu = sqrt(u). With
``lw_mode`` each atmospheric birth pre-credits -1 to its column's
absorption, its level's profile (a row of its own, added at the end, as
JAX's accz row 1) and, with the 3D tally, its cell (pallas_col.py:
1018-1064), so the absorption tallies are net of emission.

The per-pixel Lambertian albedo (pallas_col.py:714-727) is an albedo per
column, the surface grid repeated over the columns its pixels tile
(``rk.surface_px_ok``), read at the column where the photon reaches the
surface; the reflection's local estimate carries the reflected weight.

With radiance directions (pallas_col.py:745-970) every real collision and
every surface reflection adds, per direction, the local estimate
``w * Pn * exp(-tau)``: the phase value from the forward row in
s = sin(theta/2) or analytic HG over 4 pi mu (1/pi for a reflection), the
Iwabuchi roulette, and the optical depth to the top, a column walk from
the event that adds CT(z_in) - CT(z_out) per crossed column, with
CT(z) = max(0, A - B z), A = scale * (z0 + h dz), B = scale, up to the
domain top or the global maximum cloud top, plus the gas term in closed
form. The JAX kernel sums the same segments by fast-axis slab (its slab
scan); the walk crosses them in order of distance, so the two differ in
rounding order only. The contribution is tallied at the column where the
ray leaves the top. Directions march in ``col_dir_order``'s order and
direction d of a launch draws its roulette uniforms at sites 32 + 2d of the
event's lane and step, as in the JAX kernel; the image comes back in the
caller's order. The transport queues its events (``le.EventQueue``, rows
``QUEUE_FLOATS`` and ``QUEUE_INTS``) and the walk computes every (event,
direction) pair of them.

Two implementations of one launch:

* ``csrc/col_kernel.cu``, one CUDA thread per lane (``_launch_cuda``),
  then its walk kernel, one thread per (event, direction) pair over the
  whole card (``_walk_cuda``, from ``_launch_cuda`` on the same stream);
* ``col_step_plain``, the same step on ``[n_lanes]`` tensors (the local
  estimate, ``col_local_estimate_plain``, on the step's event buffer in the
  queue's layout, as ``[events * directions]`` tensors), operation for
  operation the JAX kernel's float32 arithmetic (``_build_kernel_col``
  :375-1085) without its TPU workarounds: the column fields, the emission alias
  probabilities and the per-column albedo are plain float32 arrays (no
  bf16 hi/lo split), the gathers are indexed loads (no bilinear one-hot
  products) and the tallies add exact float32 values (the JAX kernel
  rounds exit weights to bf16, absorption and radiance to a bf16 hi/lo
  pair). The JAX kernel compares the alias uniform with the probability's
  bf16 hi/lo reconstruction, within ~2^-16 of it, so a birth whose uniform
  falls between the two takes the other column there; the alias targets
  and their heights are exact in both.

The flux path runs the refill schedule by default (``run_batch_col_tallies``,
``rk.RefillSchedule``): as many slots as the card holds resident threads
for the kernel's instantiation (``occupancy``, the occupancy query;
``rk.PLAIN_SLOTS`` on the CPU), each starting its share of the batch's
photons in the kernel, in launches of ``rk.REFILL_STEPS`` steps under
``rk.relaunch_loop``; ``rk.jax_geometry`` gives the JAX package's 512 rows
of 128 lanes and 128 steps a launch. Radiance runs keep the JAX package's
4,096 lanes and 128 steps.

``col_launch`` sends CUDA tensors to the kernel and CPU tensors to the
plain step; there is no fallback between them. Both draw the counter
uniforms of ``core.rng`` at K3's sites, so for one seed they follow the
JAX kernel's photon paths.

``col_ineligibility_reasons`` is JAX's ``pallas_col_eligible`` term for
term and names each failing term.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.physics.surface import Surface, column_albedo
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import local_estimate as le
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import (Tallies,
                                                     rotate_direction,
                                                     sample_hg_cos)

# Envelope shared with the JAX column kernel (pallas_col.MAX_COLS,
# MAX_VOL_CELLS and the nz <= 128 profile; its phase row has the record
# kernel's rk.MAX_INV_ENTRIES bound; the local estimate needs nx, ny <=
# 128, col_intensity_ineligibility_reasons).
MAX_COLS = 128 * 128
MAX_VOL_CELLS = 128 * 128 * 128
MAX_NZ = 128
MAX_LE_SIDE = 128

# Kernel launches made by ``_launch_cuda`` in this process: all of them,
# those that queued local-estimate events, those that refilled from the
# column emission and those that reflected off a per-pixel albedo; and the
# walk kernel's launches made by ``_walk_cuda``.
COL_LAUNCHES = 0
COL_LE_LAUNCHES = 0
COL_LW_LAUNCHES = 0
COL_PX_LAUNCHES = 0
COL_WALK_LAUNCHES = 0

# Rows of the local-estimate event queue (csrc/col_kernel.cu QF_*, QI_*):
# the event point, its weight and the incoming direction; the lane and step
# counter that key its draws, and 1 for a reflection. A lane-step makes one
# event at most (a real collision or a reflection), so a queue of
# n_lanes * k_steps records holds any launch's events.
QUEUE_FLOATS = ("x", "y", "z", "w", "ux", "uy", "uz")
QUEUE_INTS = ("lane", "ctr", "refl")

# Draw sites of K3 (pallas_col.py:403-650): refill x/y, the source azimuth
# (random azimuth) or mu then azimuth (flux), tau, collision, angle,
# rotation azimuth, roulette; the emission refill's atmosphere/surface
# split, alias bin, alias acceptance, mu, offset in the level, azimuth and
# level (pallas_col.py:414-420); radiance direction d draws its Iwabuchi
# roulette uniforms at SITE_LE + 2d and SITE_LE + 2d + 1
# (pallas_col.py:810-811; below rng.N_SITES for d < 64).
SITE_X, SITE_Y, SITE_SRC, SITE_TAU, SITE_COLLIDE = 0, 1, 2, 3, 4
SITE_ANGLE, SITE_PHI, SITE_ROULETTE, SITE_SRC_PHI = 5, 6, 7, 9
SITE_EM_SPLIT, SITE_EM_BIN, SITE_EM_ACCEPT, SITE_EM_MU = 10, 11, 12, 13
SITE_EM_ZOFF, SITE_EM_PHI, SITE_EM_LEVEL = 14, 15, 16
SITE_LE = 32

# Source kinds of the kernel (csrc/col_kernel.cu SRC_*).
SOURCE_KINDS = (illumination.DIRECTIONAL, illumination.RANDOM_AZIMUTH,
                illumination.FLUX, illumination.EMISSION)

# Slots of the float32 parameter vector (csrc/col_kernel.cu C_*).
(C_BETA_MAX, C_ALBEDO, C_SMU, C_SUX, C_SUY, C_RR_W, C_HALF_RR, C_X0, C_LX,
 C_Y0, C_LY, C_Z0, C_LZ, C_SSA, C_G, C_INV_DX, C_INV_DY, C_INV_DZ, C_DZ,
 C_ZMAX, C_ZTOP, C_ZBOT, C_BXW, C_BYW, C_NUDGE, C_TWO_PI, C_QG, C_DXC,
 C_DYC, C_ZCL, C_ZETA, C_ATMS, N_PARAMS) = range(33)

# Launch counters (csrc/col_kernel.cu): photons started, lanes with work
# left, lane-steps with a live photon, local-estimate events, walks cut by
# the iteration bound, atmospheric emission births.
N_COUNTS = 6


_TINY = rk._TINY
_BIG = 3e38
_F32 = np.float32
# Index-space nudge of the local estimate's first column and exit pixel
# (pallas_col.py:771): a face landing names the cell the ray enters.
_NDE = 1e-4


def _has_gas(domain: OpticalDomain) -> bool:
    return domain.col_qz is not None


def col_ineligibility_reasons(domain: OpticalDomain, surface: Surface,
                              source: illumination.Source, lw_mode: bool,
                              compute_intensity: bool,
                              record_scattering_orders: int,
                              use_ray_tracing: bool,
                              need_volume_absorption: bool) -> list:
    """Names of every failing column-kernel predicate (empty = eligible):
    port of ``pallas_col.pallas_col_eligible``, term for term."""
    nx, ny, nz = domain.grid.shape
    inv = domain.tables.inverse
    ncomp = domain.n_components
    gas = _has_gas(domain)
    if gas:  # the cloud's one phase entry (the gas never scatters)
        phase_ok = (domain.col_analytic_hg
                    or inv.shape[1] <= rk.MAX_INV_ENTRIES)
    else:
        phase_ok = ((domain.all_hg and domain.uniform_hg)
                    or (inv.shape[0] == 1
                        and inv.numel() <= rk.MAX_INV_ENTRIES))
    emission = source.kind == illumination.EMISSION
    # an emission source needs its alias tables and the domain's column
    # emission tables; a per-pixel albedo takes a non-emission source (the
    # surface emission's pre-credit assumes the uniform albedo)
    em_ok = not emission or (source.em_prob is not None
                             and domain.col_em_prob is not None)
    sfc_ok = surface.is_uniform_lambertian or (
        not emission and rk.surface_px_ok(surface, domain.grid, lw_mode,
                                          max_cols=MAX_COLS))
    checks = (
        ("domain is not a column template (beta = col_scale[col] * "
         "(iz < col_height[col]) [+ col_qz[iz]])", domain.col_template),
        (f"n_components={ncomp} without the gas template (col_qz)",
         ncomp == 1 or gas),
        ("phase is neither one uniform analytic HG nor a single-row "
         f"inverse-CDF table of <= {rk.MAX_INV_ENTRIES} entries", phase_ok),
        ("single-scattering albedo is not uniform", domain.uniform_ssa or gas),
        ("irregular grid spacing",
         domain.grid.xy_regular and domain.grid.z_regular),
        ("surface is neither uniform Lambertian nor, for a non-emission "
         "source, a per-pixel Lambertian grid whose pixels tile whole "
         "columns (surface_px_ok, not with lw_mode)", sfc_ok),
        (f"source kind {source.kind!r} is not taken by the column kernel",
         source.kind in SOURCE_KINDS),
        ("emission source without its per-voxel alias (em_prob) or domain "
         "without the column emission tables (col_em_*: one component, "
         "uniform ssa, z-uniform temps, lambda_um > 0)", em_ok),
        ("lw_mode without an emission source", not lw_mode or emission),
        ("compute_intensity (radiance runs are judged by "
         "col_intensity_ineligibility_reasons)", not compute_intensity),
        ("record_scattering_orders > 0", record_scattering_orders == 0),
        ("use_ray_tracing=True (the kernel is max-cross-section only)",
         not use_ray_tracing),
        (f"3D absorption tally over {nx * ny * nz} cells > {MAX_VOL_CELLS}",
         not need_volume_absorption or nx * ny * nz <= MAX_VOL_CELLS),
        (f"nx*ny={nx * ny} > {MAX_COLS} columns", nx * ny <= MAX_COLS),
        (f"nz={nz} > {MAX_NZ}", nz <= MAX_NZ),
    )
    return [name for name, ok in checks if not ok]


def _radiance_table(domain: OpticalDomain, icfg) -> torch.Tensor:
    """The forward phase table the local estimate reads
    (pallas_col.py:1270-1273): hybrid or original."""
    return (domain.tables.forward if icfg.use_hybrid_phase
            else domain.tables.forward_orig)


def col_intensity_ineligibility_reasons(domain: OpticalDomain,
                                        surface: Surface,
                                        source: illumination.Source,
                                        lw_mode: bool,
                                        record_scattering_orders: int,
                                        use_ray_tracing: bool, icfg, dirs,
                                        need_volume_absorption: bool
                                        ) -> list:
    """Names of every failing predicate of the column kernel's local
    estimate (empty = eligible): the flux predicates plus those of
    ``pallas_col.col_intensity_ineligibility_reasons``."""
    nx, ny, nz = domain.grid.shape
    reasons = col_ineligibility_reasons(
        domain, surface, source, lw_mode, compute_intensity=False,
        record_scattering_orders=record_scattering_orders,
        use_ray_tracing=use_ray_tracing,
        need_volume_absorption=need_volume_absorption)
    table = _radiance_table(domain, icfg)
    shape_ok = dirs is not None and tuple(dirs.shape) == (3, icfg.n_dirs)
    checks = (
        (f"n_dirs={icfg.n_dirs} > {le.MAX_KERNEL_DIRS}",
         icfg.n_dirs <= le.MAX_KERNEL_DIRS),
        ("intensity_dirs is None" if dirs is None else
         f"dirs shape {tuple(dirs.shape)} != (3, {icfg.n_dirs})", shape_ok),
        (f"a direction's mu is below the floor pallas_min_mu="
         f"{icfg.pallas_min_mu}",
         shape_ok and le.dirs_mu_floor_ok(icfg, dirs)),
        ("limit_contributions (contribution capping) is not in-kernel for "
         "the column kernel", not icfg.limit_contributions),
        ("n_orders_orig_phase > 0", icfg.n_orders_orig_phase == 0),
        ("LW/emission radiance is not in-kernel for the column kernel",
         not lw_mode and source.kind != illumination.EMISSION),
        (f"max(nx, ny)={max(nx, ny)} > {MAX_LE_SIDE}",
         max(nx, ny) <= MAX_LE_SIDE),
        ("forward phase table has more than one row",
         table.shape[1] == 1 or table.shape[0] == 1),
        ("no forward table and not all-HG",
         table.shape[1] > 1 or domain.all_hg),
    )
    reasons.extend(name for name, ok in checks if not ok)
    return reasons


def _dir_keys(domain: OpticalDomain, dirs: torch.Tensor) -> list:
    """Per direction, ``pallas_col.plan_col_march``'s (fast axis, slab
    iterations): the fast axis (0 = x) is the one whose cells the ray
    crosses more of, the iterations the fast-axis cells times the wraps
    that take the shallowest event past the global maximum cloud top."""
    nx, ny, nz = domain.grid.shape
    xe, ye, ze = domain.grid.edges_np()
    lz, dxc = float(ze[-1] - ze[0]), float(xe[-1] - xe[0]) / nx
    dyc = float(ye[-1] - ye[0]) / ny
    hcl = min(_zcl_cells(domain), float(nz)) * (lz / nz)
    keys = []
    for ux, uy, uz in dirs.cpu().numpy().T.tolist():
        uz = max(uz, 1e-3)
        x_fast = abs(ux) / dxc >= abs(uy) / dyc
        uf, df, n_f = (abs(ux), dxc, nx) if x_fast else (abs(uy), dyc, ny)
        travel_cells = hcl / uz * uf / df
        keys.append((0 if x_fast else 1,
                     n_f * (int((travel_cells + 1.0) // n_f) + 1)))
    return keys


def col_dir_order(domain: OpticalDomain, dirs: torch.Tensor) -> tuple:
    """The order the column kernel marches the directions in: the sort of
    ``pallas_col.plan_col_march`` by (fast axis, slab iterations)
    (``_dir_keys``), ties in the caller's order. Direction d of a launch is
    the caller's direction ``order[d]`` and draws its roulette uniforms at
    sites 32 + 2d, so the JAX kernel's photon paths and estimates need the
    same order."""
    keys = _dir_keys(domain, dirs)
    return tuple(sorted(range(len(keys)), key=lambda i: keys[i]))


def _zcl_cells(domain: OpticalDomain) -> float:
    """The global maximum cloud top, in cells
    (``pallas_col._col_zcl_cells``)."""
    cache = domain.__dict__
    if "_zcl_cells" not in cache:
        cache["_zcl_cells"] = float(torch.max(domain.col_height))
    return cache["_zcl_cells"]


def walk_bound(domain: OpticalDomain, dirs: torch.Tensor) -> int:
    """Iteration bound of a launch's column walks: the x and y faces the
    steepest-slanted direction crosses from the domain bottom to its top,
    plus margin. No walk of an eligible run reaches it (each iteration
    crosses a face or ends the walk); one that would is cut and counted,
    never left to run on."""
    nx, ny, nz = domain.grid.shape
    xe, ye, ze = domain.grid.edges_np()
    lz, dxc = float(ze[-1] - ze[0]), float(xe[-1] - xe[0]) / nx
    dyc = float(ye[-1] - ye[0]) / ny
    bound = 0
    for ux, uy, uz in dirs.double().cpu().T.tolist():
        h = lz / max(uz, 1e-3)
        bound = max(bound, int(np.ceil(h * abs(ux) / dxc))
                    + int(np.ceil(h * abs(uy) / dyc)))
    return bound + 8


# ---------------------------------------------------------------------------
# Kernel inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ColState:
    """Per-lane photon state ([n_lanes] each): the record kernel's, with the
    carried block majorant split into its scale ``bls`` and cloud-top
    height ``blh`` (cells)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    w: torch.Tensor
    bls: torch.Tensor
    blh: torch.Tensor
    quota: torch.Tensor   # int32 photons still to start on this lane
    alive: torch.Tensor   # int32 0/1

    FLOAT_FIELDS = ("x", "y", "z", "ux", "uy", "uz", "w", "bls", "blh")
    INT_FIELDS = ("quota", "alive")

    @staticmethod
    def initial(quota: torch.Tensor, beta_max: float, nz: int) -> "ColState":
        """Fresh lanes: no photon alive, ``quota`` photons to start, the
        global ceiling carried."""
        n = quota.shape[0]
        dev = quota.device

        def full(v):
            return torch.full((n,), v, dtype=torch.float32, device=dev)

        return ColState(x=full(0.0), y=full(0.0), z=full(0.0), ux=full(0.0),
                        uy=full(0.0), uz=full(1.0), w=full(0.0),
                        bls=full(beta_max), blh=full(float(nz)),
                        quota=quota.to(torch.int32).contiguous(),
                        alive=torch.zeros(n, dtype=torch.int32, device=dev))


def _col_ab(domain: OpticalDomain) -> torch.Tensor:
    """[nx*ny, 2] float32, per column (A, B) of the local estimate's
    closed-form column optical depth CT(z) = max(0, A - B z):
    A = scale * (z0 + h dz), B = scale, computed in float32 as
    ``pallas_col._pack_col_ab`` does (without its slab layout), interleaved
    so the walk reads a column's pair in one 8-byte load; cached on the
    domain."""
    cache = domain.__dict__
    if "_col_ab" not in cache:
        nz = domain.grid.shape[2]
        ze = domain.grid.edges_f32()[2]
        dz = (ze[-1] - ze[0]) / _F32(nz)
        scale = domain.col_scale.cpu().numpy().astype(np.float32)
        h = domain.col_height.cpu().numpy()
        a = (scale * (ze[0] + h * dz)).astype(np.float32)
        cache["_col_ab"] = torch.tensor(np.stack([a, scale], axis=1),
                                        device=domain.device)
    return cache["_col_ab"]


@dataclasses.dataclass(frozen=True)
class ColTables:
    """Device tables the step reads: the column fields (``col_hs`` [nx*ny,
    2], each column's (height, scale) interleaved, the kernel's one 8-byte
    load; ``col_height`` and ``col_scale`` are its columns), the xy-block table
    [nbx*nby, 2] (majorant scale, cloud-top height) flattened, the cloud's
    inverse-CDF row with its forward differences, the gas profile ``qz``
    with ``qcb[k]``, the gas optical depth from the bottom of level k to
    the top, and for radiance the CT coefficients ``col_ab`` [nx*ny, 2]
    (``_col_ab``), the direction cosines [3, n_dirs] in march order and the
    forward phase table (``rk.forward_table``, row 0 read), for the
    emission refill the
    column alias (probability, target, the target's height) and the
    cumulative Planck table, and for a per-pixel surface the albedo per
    column (``column_albedo``); one-element placeholders where unused.
    ``dirs`` [4, n_dirs] holds the direction cosines in march order and,
    in row 3, 1 where x is the direction's fast axis (``_dir_keys``), which
    decides how the walk's first column is found."""

    col_hs: torch.Tensor
    blocks: torch.Tensor
    inv_a0: torch.Tensor
    inv_dd: torch.Tensor
    qz: torch.Tensor
    qcb: torch.Tensor
    col_ab: torch.Tensor
    dirs: torch.Tensor
    fwd_v0: torch.Tensor
    fwd_dd: torch.Tensor
    em_prob: torch.Tensor
    em_alias: torch.Tensor
    em_halias: torch.Tensor
    em_fcum: torch.Tensor
    albedo: torch.Tensor

    @staticmethod
    def from_domain(domain: OpticalDomain, icfg=None, dirs=None,
                    emission: bool = False,
                    surface: Surface = None) -> "ColTables":
        """The tables of ``domain``; with ``icfg`` the radiance tables for
        ``dirs`` [3, n_dirs], given in march order; with ``emission`` the
        column emission tables; with a per-pixel ``surface`` its albedo per
        column."""
        zero = torch.zeros(1, dtype=torch.float32, device=domain.device)
        gas = _has_gas(domain)
        if domain.col_analytic_hg if gas else domain.all_hg:
            a0 = dd = zero
        else:  # the cloud's row (pallas_col.py:1234-1242)
            a0 = domain.tables.inverse[domain.col_inv_row].contiguous()
            dd = (torch.cat([a0[1:], a0[-1:]]) - a0).contiguous()
        blocks = (domain.macro_table.reshape(-1).contiguous()
                  if domain.macro_factor > 0 else zero)
        qz = qcb = zero
        if gas:  # pallas_col.py:1243-1253, in float32 from the top down
            nz = domain.grid.shape[2]
            ze = domain.grid.edges_f32()[2]
            q = domain.col_qz.cpu().numpy()
            qcb_np = (np.cumsum(q[::-1], dtype=np.float32)[::-1]
                      * ((ze[-1] - ze[0]) / _F32(nz))).astype(np.float32)
            qz = domain.col_qz.contiguous()
            qcb = torch.tensor(qcb_np, device=domain.device)
        col_ab = dvec = v0 = fdd = zero
        if icfg is not None:
            col_ab = _col_ab(domain)
            fast_x = [float(axis == 0) for axis, _ in _dir_keys(domain, dirs)]
            dvec = torch.cat([dirs.to(dtype=torch.float32).cpu(),
                              torch.tensor([fast_x])]).to(
                                  domain.device).contiguous()
            if _radiance_table(domain, icfg).shape[1] > 1:
                v0, fdd = rk.forward_table(domain, icfg.use_hybrid_phase)
        em = (domain.col_em_prob, domain.col_em_alias, domain.col_em_halias,
              domain.col_em_fcum) if emission else (zero,) * 4
        nx, ny, _ = domain.grid.shape
        alb = (column_albedo(surface, nx, ny, domain.device)
               if surface is not None and not surface.is_uniform_lambertian
               else zero)
        col_hs = torch.stack([domain.col_height, domain.col_scale],
                             dim=1).to(torch.float32).contiguous()
        return ColTables(col_hs=col_hs, blocks=blocks, inv_a0=a0,
                         inv_dd=dd, qz=qz, qcb=qcb, col_ab=col_ab, dirs=dvec,
                         fwd_v0=v0, fwd_dd=fdd,
                         em_prob=em[0].contiguous(),
                         em_alias=em[1].contiguous(),
                         em_halias=em[2].contiguous(),
                         em_fcum=em[3].contiguous(), albedo=alb)

    @property
    def col_height(self) -> torch.Tensor:
        return self.col_hs[:, 0]

    @property
    def col_scale(self) -> torch.Tensor:
        return self.col_hs[:, 1]


@dataclasses.dataclass(frozen=True)
class ColParams:
    """Scalars of one batch: ``values`` is the float32 parameter vector
    (C_* slots, computed in float32 as the JAX kernel computes them),
    ``device_values`` its copy on the kernel's device."""

    values: np.ndarray
    device_values: torch.Tensor
    nx: int
    ny: int
    nz: int
    macro_factor: int
    nbx: int
    nby: int
    analytic_hg: bool
    inv_n_steps: int
    use_rr: bool
    need_vol: bool
    source_kind: int   # index into SOURCE_KINDS
    has_gas: bool = False
    # the emission refill's pre-credits (lw_mode with an emission source)
    # and the per-pixel albedo
    lw: bool = False
    has_px: bool = False
    # local estimate: directions, Iwabuchi roulette, the forward row (else
    # analytic HG) and the walk's iteration bound
    n_dirs: int = 0
    le_rr: bool = False
    le_fwd: bool = False
    k_walk: int = 0

    def __getitem__(self, slot: int) -> float:
        return float(self.values[slot])

    @property
    def n_acc(self) -> int:
        """Tally entries: [up nxy | down nxy | absorbed nxy | profile nz |
        3D field nxy*nz, row-major (column, level), with need_vol | the
        profile's pre-credits nz, with lw]."""
        nxy = self.nx * self.ny
        return (3 * nxy + self.nz + (nxy * self.nz if self.need_vol else 0)
                + (self.nz if self.lw else 0))

    @property
    def off_vol(self) -> int:
        """Offset of the 3D field (and, without it, of the pre-credit
        row) in the tallies."""
        return 3 * self.nx * self.ny + self.nz

    @property
    def off_pre(self) -> int:
        """Offset of the profile's pre-credit row in the tallies."""
        nxy = self.nx * self.ny
        return self.off_vol + (nxy * self.nz if self.need_vol else 0)

    @property
    def n_img(self) -> int:
        """Radiance image entries: [n_dirs, nx*ny] in march order."""
        return self.n_dirs * self.nx * self.ny

    @staticmethod
    def make(domain: OpticalDomain, surface: Surface,
             source: illumination.Source, use_russian_roulette: bool,
             russian_roulette_weight: float, need_vol: bool,
             intensity_config=None, intensity_dirs=None,
             lw_mode: bool = False) -> "ColParams":
        f = _F32
        nx, ny, nz = domain.grid.shape
        xe, ye, ze = domain.grid.edges_f32()
        beta_max = max(f(domain.max_extinction), f(_TINY))
        if source.kind in (illumination.DIRECTIONAL,
                           illumination.RANDOM_AZIMUTH):
            smu = f(source.solar_mu)
            sphi = (f(source.solar_azimuth)
                    if source.kind == illumination.DIRECTIONAL else f(0.0))
        else:
            smu, sphi = f(0.0), f(0.0)
        sth = np.sqrt(max(f(0.0), f(1.0) - smu * smu))
        lx, ly, lz = xe[-1] - xe[0], ye[-1] - ye[0], ze[-1] - ze[0]
        mf = int(domain.macro_factor)
        bxw, byw = lx / f(nx) * f(mf), ly / f(ny) * f(mf)
        rr_w = f(russian_roulette_weight)
        z_max, z_eps = ze[0] + lz, lz * f(1e-6)
        dz = lz / f(nz)
        gas = _has_gas(domain)
        vals = np.zeros(N_PARAMS, np.float32)
        vals[[C_BETA_MAX, C_ALBEDO, C_SMU, C_SUX, C_SUY, C_RR_W,
              C_HALF_RR]] = (beta_max, f(surface.albedo), smu,
                             sth * np.cos(sphi), sth * np.sin(sphi), rr_w,
                             f(0.5) * rr_w)
        vals[[C_X0, C_LX, C_Y0, C_LY, C_Z0, C_LZ]] = (
            xe[0], lx, ye[0], ly, ze[0], lz)
        if gas:
            # the cloud's ssa and HG g from detection (the records of two
            # components differ) and the gas maximum (pallas_col.py:1330-1337)
            vals[[C_SSA, C_G, C_QG]] = domain.col_cloud
        else:  # one component: ssa at record slot 3, HG g at slot 5
            rec0 = domain.cell_records[0].cpu().numpy()
            vals[[C_SSA, C_G]] = (rec0[3], rec0[5])
        vals[[C_INV_DX, C_INV_DY, C_INV_DZ, C_DZ]] = (
            f(nx) / lx, f(ny) / ly, f(nz) / lz, dz)
        vals[[C_ZMAX, C_ZTOP, C_ZBOT]] = (z_max, z_max - z_eps,
                                          ze[0] + z_eps)
        vals[[C_BXW, C_BYW, C_NUDGE, C_TWO_PI]] = (
            bxw, byw, f(1e-5) * min(bxw, byw), f(2.0 * np.pi))
        vals[[C_DXC, C_DYC]] = lx / f(nx), ly / f(ny)
        emission = source.kind == illumination.EMISSION
        # the atmosphere/surface split of the emission refill (param 16)
        vals[C_ATMS] = f(source.atms_fraction) if emission else f(0.0)
        icfg = intensity_config
        le_kw = {}
        if icfg is not None:
            vals[C_ZETA] = f(icfg.zeta_min)
            vals[C_ZCL] = ze[0] + f(_zcl_cells(domain)) * dz
            le_kw = dict(
                n_dirs=int(icfg.n_dirs),
                le_rr=bool(icfg.use_russian_roulette),
                le_fwd=_radiance_table(domain, icfg).shape[1] > 1,
                k_walk=walk_bound(domain, intensity_dirs))
        return ColParams(
            values=vals,
            device_values=torch.as_tensor(vals, device=domain.device),
            nx=nx, ny=ny, nz=nz, macro_factor=mf,
            nbx=-(-nx // mf) if mf else 0, nby=-(-ny // mf) if mf else 0,
            analytic_hg=bool(domain.col_analytic_hg if gas
                             else domain.all_hg),
            inv_n_steps=int(domain.tables.inverse.shape[1]),
            use_rr=bool(use_russian_roulette), need_vol=bool(need_vol),
            source_kind=SOURCE_KINDS.index(source.kind), has_gas=gas,
            lw=bool(lw_mode) and emission,
            has_px=not surface.is_uniform_lambertian, **le_kw)


@dataclasses.dataclass(frozen=True)
class ColTally:
    """What a launch adds into: ``acc`` the tallies [prm.n_acc] f32,
    ``img`` the radiance image [prm.n_img] f32, ``counts`` int64 [photons
    started, lanes with work left, lane-steps run with a live photon,
    local-estimate events, walks cut, atmospheric emission births]
    (``rk.relaunch_loop`` layout),
    ``walk`` int64 [1] the column-walk iterations and, for the kernel's
    radiance launches, ``queue`` the event queue they reuse."""

    acc: torch.Tensor
    img: torch.Tensor
    counts: torch.Tensor
    walk: torch.Tensor
    queue: le.EventQueue = None

    @staticmethod
    def zeros(prm: ColParams, device, queue_capacity: int = 0) -> "ColTally":
        """Zero tallies; on a CUDA device with radiance directions and a
        ``queue_capacity`` (lanes times steps per launch), the event
        queue."""
        dev = torch.device(device)
        queue = None
        if prm.n_dirs and queue_capacity and dev.type == "cuda":
            queue = le.EventQueue.empty(len(QUEUE_FLOATS), len(QUEUE_INTS),
                                        queue_capacity, dev)
        return ColTally(
            acc=torch.zeros(prm.n_acc, dtype=torch.float32, device=dev),
            img=torch.zeros(max(1, prm.n_img), dtype=torch.float32,
                            device=dev),
            counts=torch.zeros(N_COUNTS, dtype=torch.int64, device=dev),
            walk=torch.zeros(1, dtype=torch.int64, device=dev), queue=queue)


# ---------------------------------------------------------------------------
# Plain PyTorch step
# ---------------------------------------------------------------------------

def col_step_plain(st: ColState, tab: ColTables, prm: ColParams,
                   lane: torch.Tensor, seed: int, ctr: int,
                   tally: ColTally) -> torch.Tensor:
    """One transport step for every lane; returns the photons started.

    ``lane`` holds the int64 lane indices, ``ctr`` the step counter;
    ``tally`` receives this step's tallies. Operation for operation the
    JAX kernel's float32 arithmetic (pallas_col.py _build_kernel_col)."""
    p = prm
    u = rng.make_uniform(lane, seed)
    x0, lx, y0, ly = p[C_X0], p[C_LX], p[C_Y0], p[C_LY]
    z0, z_max, beta_max = p[C_Z0], p[C_ZMAX], p[C_BETA_MAX]
    nx, ny, nz = p.nx, p.ny, p.nz
    nxy = nx * ny
    mf = p.macro_factor
    two_pi = p[C_TWO_PI]
    x, y, z, ux, uy, uz, w = st.x, st.y, st.z, st.ux, st.uy, st.uz, st.w
    bls, blh = st.bls, st.blh

    # ---- refill dead lanes from the source ----
    alive = st.alive > 0
    need = ~alive & (st.quota > 0)
    kind = SOURCE_KINDS[p.source_kind]
    if kind == illumination.EMISSION:
        xb, yb, zb, s_mu, from_atm, col_b, lvl_b = col_emission_refill(
            u, ctr, tab, p)
        x = torch.where(need, xb, x)
        y = torch.where(need, yb, y)
        z = torch.where(need, zb, z)
        tally.counts[5] += (need & from_atm).sum()
    else:
        x = torch.where(need, x0 + u(ctr, SITE_X) * lx, x)
        y = torch.where(need, y0 + u(ctr, SITE_Y) * ly, y)
        z = torch.where(need, p[C_ZTOP], z)
    if kind == illumination.DIRECTIONAL:
        s_mu = torch.full_like(x, -p[C_SMU])
        sux = torch.full_like(x, p[C_SUX])
        suy = torch.full_like(x, p[C_SUY])
    else:
        if kind == illumination.EMISSION:
            s_phi = two_pi * u(ctr, SITE_EM_PHI)
        elif kind == illumination.RANDOM_AZIMUTH:
            s_mu = torch.full_like(x, -p[C_SMU])
            s_phi = two_pi * u(ctr, SITE_SRC)
        else:  # flux: mu = -sqrt(u), azimuth at its own site
            s_mu = -torch.sqrt(torch.clamp(u(ctr, SITE_SRC), min=1e-12))
            s_phi = two_pi * u(ctr, SITE_SRC_PHI)
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
    tally.counts[2] += alive.sum()
    # fresh photons carry the (always valid) global ceiling
    bls = torch.where(need, beta_max, bls)
    blh = torch.where(need, float(nz), blh)

    # ---- Woodcock jump against the carried block ceiling ----
    tau = -torch.log1p(-u(ctr, SITE_TAU))
    ztop_m = z0 + blh * p[C_DZ]          # block cloud-top plane
    above = z >= ztop_m
    if p.has_gas:
        # gas everywhere: above the plane the photon samples against the
        # gas maximum instead of advancing geometrically
        ceiling = torch.where(above, p[C_QG], bls + p[C_QG])
    else:
        ceiling = torch.where(above, 0.0, bls)
    d_samp = torch.where(ceiling > 0,
                         tau / torch.where(ceiling == 0, 1.0, ceiling), _BIG)
    if mf > 0:
        tx = rk.face_distance(x, x0, ux, p[C_BXW], lx)
        ty = rk.face_distance(y, y0, uy, p[C_BYW], ly)
        # descending into the cloud region: the zero ceiling is only valid
        # above the plane
        tz = torch.where(above & (uz < -1e-12),
                         (ztop_m - z) / torch.where(uz == 0, 1.0, uz), _BIG)
        t_raw = torch.minimum(torch.minimum(tx, ty), tz)
        # a photon exactly on an outward face takes one global-ceiling step
        escape = t_raw <= 0.0
        bls = torch.where(escape, beta_max, bls)
        blh = torch.where(escape, float(nz), blh)
        ceiling = torch.where(escape, beta_max, ceiling)
        d_samp = torch.where(escape, rk.div_scalar(tau, beta_max), d_samp)
        t_clip = torch.where(escape, _BIG, t_raw + p[C_NUDGE])
        clipped = t_clip < d_samp
        d = torch.minimum(d_samp, t_clip)
    else:
        clipped = torch.zeros_like(alive)
        d = torch.where(ceiling > 0, d_samp, _BIG)
    zn = z + uz * d
    exit_top = alive & (zn >= z_max)
    exit_bot = alive & ~exit_top & (zn <= z0)
    moved = alive & ~exit_top & ~exit_bot
    collide = moved & ~clipped

    # boundary crossing column (exit tallies + reflection)
    z_b = torch.where(exit_top, z_max, z0)
    t_b = (z_b - z) / torch.where(uz.abs() < 1e-12, 1.0, uz)
    xe = x0 + torch.remainder((x + ux * t_b) - x0, lx)
    ye = y0 + torch.remainder((y + uy * t_b) - y0, ly)
    ixe = ((xe - x0) * p[C_INV_DX]).to(torch.int32).clamp(0, nx - 1)
    iye = ((ye - y0) * p[C_INV_DY]).to(torch.int32).clamp(0, ny - 1)
    col_e = ixe * ny + iye

    # collision column / level
    xc = x0 + torch.remainder((x + ux * d) - x0, lx)
    yc = y0 + torch.remainder((y + uy * d) - y0, ly)
    zc = torch.clamp(zn, z0, z_max)
    ix = ((xc - x0) * p[C_INV_DX]).to(torch.int32).clamp(0, nx - 1)
    iy = ((yc - y0) * p[C_INV_DY]).to(torch.int32).clamp(0, ny - 1)
    iz = ((zc - z0) * p[C_INV_DZ]).to(torch.int32).clamp(0, nz - 1)
    col = ix * ny + iy
    exits = exit_top | exit_bot

    u_ang = u(ctr, SITE_ANGLE)
    phi_rot = two_pi * u(ctr, SITE_PHI)

    # ---- column gather (+ the gas at the collision level) ----
    col_l = col.long()
    beta_c = torch.where(iz.to(torch.float32) < tab.col_height[col_l],
                         tab.col_scale[col_l], 0.0)
    beta = beta_c + tab.qz[iz.long()] if p.has_gas else beta_c

    # ---- block-majorant gather at the destination ----
    if mf > 0:
        bidx = ((ix // mf) * p.nby + iy // mf).long()
        bls = torch.where(moved, tab.blocks[2 * bidx], bls)
        blh = torch.where(moved, tab.blocks[2 * bidx + 1], blh)

    # null-collision test against the ceiling this jump sampled with
    real = collide & (u(ctr, SITE_COLLIDE) * ceiling < beta)
    if p.has_gas:
        # the gas absorbs only: the cell scatters beta_c * ssa of beta
        ssa = torch.where(beta > 0, (beta_c * p[C_SSA])
                          / torch.where(beta == 0, 1.0, beta), 0.0)
    else:
        ssa = p[C_SSA]
    absorbed = torch.where(real, w * (1.0 - ssa), 0.0)
    w = torch.where(real, w * ssa, w)
    # post-absorption, pre-roulette weight: a scatter's local estimate
    w_int = w

    # ---- Russian roulette ----
    if p.use_rr:
        rr_w = p[C_RR_W]
        play = real & (w < p[C_HALF_RR])
        survive = u(ctr, SITE_ROULETTE) < rk.div_scalar(w, rr_w)
        w = torch.where(play, torch.where(survive, rr_w, 0.0), w)
    died_weight = real & (w <= _TINY)

    # ---- scattering: analytic HG (uniform g) or the single inverse-CDF
    # row ----
    scatter = real & ~died_weight
    if p.analytic_hg:
        cos_t = sample_hg_cos(torch.full_like(u_ang, p[C_G]), u_ang)
    else:
        n_steps = p.inv_n_steps
        t_u = u_ang * float(n_steps - 1)
        k = t_u.to(torch.int32).clamp(0, n_steps - 2)
        frac = t_u - k.to(torch.float32)
        k = k.long()
        cos_t = torch.cos(tab.inv_a0[k] + frac * tab.inv_dd[k])
    ux_in, uy_in, uz_in = ux, uy, uz
    ox, oy, oz = rotate_direction(ux, uy, uz, cos_t, phi_rot)
    ux = torch.where(scatter, ox, ux)
    uy = torch.where(scatter, oy, uy)
    uz = torch.where(scatter, oz, uz)

    # ---- Lambertian surface reflection: the uniform albedo or the
    # albedo of the column the photon reaches the surface in ----
    w_down = w
    w_refl = w_down * (tab.albedo[col_e.long()] if p.has_px
                       else p[C_ALBEDO])
    died_surface = exit_bot & (w_refl <= _TINY)
    reflected = exit_bot & ~died_surface
    mu_new = torch.sqrt(torch.clamp(u_ang, min=1e-12))
    sin_new = torch.sqrt(torch.clamp(1.0 - mu_new * mu_new, min=0.0))
    x = torch.where(exit_bot, xe, torch.where(moved, xc, x))
    y = torch.where(exit_bot, ye, torch.where(moved, yc, y))
    z = torch.where(exit_bot, p[C_ZBOT], torch.where(moved, zc, z))
    ux = torch.where(reflected, sin_new * torch.cos(phi_rot), ux)
    uy = torch.where(reflected, sin_new * torch.sin(phi_rot), uy)
    uz = torch.where(reflected, mu_new, uz)
    w = torch.where(reflected, w_refl, w)
    # reflected photons restart with the global ceiling
    bls = torch.where(exit_bot, beta_max, bls)
    blh = torch.where(exit_bot, float(nz), blh)
    alive = alive & ~exit_top & ~died_weight & ~died_surface

    # ---- local estimate of every real collision and reflection: the
    # step's events in the queue's layout (QUEUE_FLOATS, QUEUE_INTS),
    # counted as they are queued ----
    if p.n_dirs:
        ev = torch.nonzero(real | reflected).reshape(-1)
        tally.counts[3] += ev.numel()
        if ev.numel():
            refl = reflected[ev]
            f = torch.stack([torch.where(refl, xe[ev], xc[ev]),
                             torch.where(refl, ye[ev], yc[ev]),
                             torch.where(refl, p[C_ZBOT], zc[ev]),
                             torch.where(refl, w_refl[ev], w_int[ev]),
                             ux_in[ev], uy_in[ev], uz_in[ev]])
            i = torch.stack([lane[ev], torch.full_like(ev, ctr),
                             refl.long()]).to(torch.int32)
            col_local_estimate_plain(tab, p, seed, f, i, tally)

    # ---- tallies: exits at the crossing column, absorption at the
    # collision column, its level and (need_vol) its cell ----
    t_val = torch.where(exit_top, w, torch.where(exit_bot, w_down, absorbed))
    t_val = torch.where(exits | real, t_val, 0.0)
    t_idx = torch.where(exits, torch.where(exit_top, col_e, nxy + col_e),
                        2 * nxy + col)
    acc = tally.acc
    acc.index_add_(0, t_idx.long(), t_val)
    acc[3 * nxy:3 * nxy + nz] += rk.level_sums(iz, absorbed, nz)
    if p.need_vol:
        acc.index_add_(0, p.off_vol + col_l * nz + iz.long(), absorbed)
    if p.lw:
        # -1 at each atmospheric birth's column, level (the pre-credit row)
        # and cell; a level count of nz (u * fcum[h - 1] rounded up to the
        # table's last entry) is the top level, where the birth's z is
        # clamped
        neg = torch.where(need & from_atm, -1.0, 0.0)
        lvl = torch.clamp(lvl_b, max=nz - 1).long()
        acc.index_add_(0, (2 * nxy + col_b).long(), neg)
        acc[p.off_pre:p.off_pre + nz] += rk.level_sums(lvl, neg, nz)
        if p.need_vol:
            acc.index_add_(0, p.off_vol + col_b.long() * nz + lvl, neg)

    st.x, st.y, st.z, st.ux, st.uy, st.uz, st.w = x, y, z, ux, uy, uz, w
    st.bls, st.blh = bls, blh
    st.quota = quota
    st.alive = alive.to(torch.int32)
    return started


def col_emission_refill(u, ctr: int, tab: ColTables, p: ColParams):
    """The column BBEmission refill of every lane (pallas_col.py:407-466):
    returns the birth point (x, y, z), mu, the atmosphere/surface split,
    the birth column and the birth level count.

    A uniform against ``atms_fraction`` splits atmosphere from surface. An
    atmospheric photon's column is a Walker alias draw (a uniform bin,
    redirected to its alias when the acceptance uniform reaches the bin's
    probability), its level the count #{k : fcum[k] <= u * fcum[h - 1]}
    of the cumulative Planck table truncated at the column's height h (the
    alias target's height is a table of its own, so one lookup serves
    both); it starts uniform in that cell, z kept z_eps inside the domain,
    with an isotropic mu of magnitude at least 1e-4. A surface photon
    starts uniform on the surface with mu = sqrt(u). The JAX kernel splits
    the column with a float32 reciprocal of ny, which equals the integer
    division for nx * ny <= 16,384."""
    nx, ny, nz = p.nx, p.ny, p.nz
    nxy = nx * ny
    x0, y0, z0 = p[C_X0], p[C_Y0], p[C_Z0]
    u0 = u(ctr, SITE_X)
    u1 = u(ctr, SITE_Y)
    from_atm = u(ctr, SITE_EM_SPLIT) < p[C_ATMS]
    jbin = torch.clamp((u(ctr, SITE_EM_BIN) * float(nxy)).to(torch.int32),
                       max=nxy - 1)
    jl = jbin.long()
    redirect = u(ctr, SITE_EM_ACCEPT) >= tab.em_prob[jl]
    col_b = torch.where(redirect, (tab.em_alias[jl] + 0.5).to(torch.int32),
                        jbin)
    h_b = torch.where(redirect, tab.em_halias[jl], tab.col_height[jl])
    hz = torch.clamp(h_b.to(torch.int32) - 1, 0, nz - 1)
    target = u(ctr, SITE_EM_LEVEL) * tab.em_fcum[hz.long()]
    # fcum is nondecreasing: the count of entries <= target
    z_b = torch.searchsorted(tab.em_fcum, target, right=True).to(torch.int32)
    xa = x0 + ((col_b // ny).to(torch.float32) + u0) * p[C_DXC]
    ya = y0 + ((col_b % ny).to(torch.float32) + u1) * p[C_DYC]
    za = torch.clamp(z0 + (z_b.to(torch.float32) + u(ctr, SITE_EM_ZOFF))
                     * p[C_DZ], p[C_ZBOT], p[C_ZTOP])
    u_mu = u(ctr, SITE_EM_MU)
    mu_a = 1.0 - 2.0 * u_mu
    mu_a = torch.where(mu_a.abs() < 1e-4, torch.sign(mu_a + _TINY) * 1e-4,
                       mu_a)
    mu_sfc = torch.sqrt(torch.clamp(u_mu, min=1e-12))
    return (torch.where(from_atm, xa, x0 + u0 * p[C_LX]),
            torch.where(from_atm, ya, y0 + u1 * p[C_LY]),
            torch.where(from_atm, za, p[C_ZBOT]),
            torch.where(from_atm, mu_a, mu_sfc), from_atm, col_b, z_b)


def col_local_estimate_plain(tab: ColTables, prm: ColParams, seed: int,
                             f: torch.Tensor, i: torch.Tensor,
                             tally: ColTally) -> None:
    """Local estimate of a buffer of events toward every direction, tallied
    into ``tally.img``; the walk iterations go to ``tally.walk`` and walks
    cut by the bound to ``tally.counts[4]``. ``f`` float32 [7, n] and ``i``
    int32 [3, n] are the events in the queue's layout (``QUEUE_FLOATS``:
    the point, weight and incoming direction; ``QUEUE_INTS``: the lane and
    step that key the draws, 1 for a reflection), as the kernel's transport
    queues them (``le.EventQueue.queued``) or as ``col_step_plain`` builds
    them; the order of the events changes the image's rounding only.

    Same float32 arithmetic as csrc/col_kernel.cu's ``le_pair``: all
    (event, direction) pairs walk together, each until it passes its stop
    height."""
    p = prm
    nx, ny, nz, n_dirs = p.nx, p.ny, p.nz, p.n_dirs
    nxy = nx * ny
    x0, y0, z0, z_max = p[C_X0], p[C_Y0], p[C_Z0], p[C_ZMAX]
    inv_dx, inv_dy, dxc, dyc = p[C_INV_DX], p[C_INV_DY], p[C_DXC], p[C_DYC]
    sx, sy, sz, w_ev, ux_in, uy_in, uz_in = f
    lanes = i[0].long()
    ctrs = i[1].long() & 0xFFFF_FFFF  # uint32 step counters
    refl = i[2] != 0
    n_ev = lanes.shape[0]

    def pairs(v):  # per event -> per (event, direction), event-major
        return v.repeat_interleave(n_dirs)

    d_idx = torch.arange(n_dirs, device=lanes.device).repeat(n_ev)
    ddx, ddy, ddz = (tab.dirs[i][d_idx] for i in range(3))
    sx, sy, sz, w_p = pairs(sx), pairs(sy), pairs(sz), pairs(w_ev)
    refl_p = pairs(refl)

    # ---- phase value (pallas_col.py:783-804) ----
    cosb = (pairs(ux_in) * ddx + pairs(uy_in) * ddy) + pairs(uz_in) * ddz
    if p.le_fwd:  # the forward row, uniform in s = sin(theta/2)
        s_v = torch.sqrt(torch.clamp((1.0 - cosb) * 0.5, min=0.0))
        tpos = s_v * float(rk.FWD_N_S - 1)
        k_f = tpos.to(torch.int32).clamp(0, rk.FWD_N_S - 2)
        frac = tpos - k_f.to(torch.float32)
        k_f = k_f.long()
        pv = tab.fwd_v0[k_f] + frac * tab.fwd_dd[k_f]
    else:  # analytic HG; the scalar factors in float32, as in the kernel
        g = _F32(p[C_G])
        q = torch.clamp(float(_F32(1.0) + g * g) - float(_F32(2.0) * g)
                        * cosb, min=1e-12)
        pv = float(_F32(1.0) - g * g) / (q * torch.sqrt(q))
    npf = torch.where(refl_p, float(_F32(1.0 / np.pi)),
                      pv / (float(_F32(4.0 * np.pi)) * ddz))
    if p.le_rr:  # Iwabuchi roulette draws at sites 32 + 2d, 33 + 2d
        lane_p, ctr_p = pairs(lanes), pairs(ctrs)
        u_i1 = rng.uniform_at(lane_p, ctr_p, SITE_LE + 2 * d_idx, seed)
        tau_free = -torch.log1p(-rng.uniform_at(
            lane_p, ctr_p, SITE_LE + 1 + 2 * d_idx, seed))
        zeta = p[C_ZETA]
        npf_pi = float(_F32(np.pi)) * npf
        small = npf_pi <= zeta
        tau_max = -torch.log(torch.full_like(npf_pi, zeta)
                             / torch.clamp(npf_pi, min=_TINY))

    # ---- column walk from the event to the top (or past the highest
    # cloud top, above which every CT is 0) ----
    t_top = (z_max - sz) / ddz
    t_stop = torch.minimum(torch.clamp((p[C_ZCL] - sz) / ddz, min=0.0),
                           t_top)
    # the first column (pallas_col.py:837-876): on the fast axis the cell
    # the ray enters at a face, on the slow axis the cell after a nudge of
    # 1e-4 cells along the direction (a zero component counts as positive)
    fx, fy = (sx - x0) * inv_dx, (sy - y0) * inv_dy
    up_x, up_y = (ddx >= 0).long(), (ddy >= 0).long()
    fast_x = tab.dirs[3][d_idx] != 0
    jx = torch.where(
        fast_x, torch.where(up_x > 0, torch.floor(fx), torch.ceil(fx) - 1.0),
        torch.floor(fx + torch.where(up_x > 0, _NDE, -_NDE))).long()
    jy = torch.where(
        fast_x, torch.floor(fy + torch.where(up_y > 0, _NDE, -_NDE)),
        torch.where(up_y > 0, torch.floor(fy), torch.ceil(fy) - 1.0)).long()
    step_x, step_y = 2 * up_x - 1, 2 * up_y - 1
    live_x, live_y = ddx.abs() > 1e-12, ddy.abs() > 1e-12
    sdx = torch.where(live_x, ddx, 1.0)
    sdy = torch.where(live_y, ddy, 1.0)

    def face_x(j):  # distance to the x face the ray leaves column j by
        return torch.where(
            live_x, (((j + up_x).to(torch.float32) * dxc + x0) - sx) / sdx,
            _BIG)

    def face_y(j):
        return torch.where(
            live_y, (((j + up_y).to(torch.float32) * dyc + y0) - sy) / sdy,
            _BIG)

    tx, ty = face_x(jx), face_y(jy)
    t = torch.zeros_like(sx)
    tau_cl = torch.zeros_like(sx)
    act = torch.ones_like(refl_p)
    n_walk = 0
    for _ in range(p.k_walk):
        if not bool(act.any()):
            break
        tn = torch.minimum(torch.minimum(tx, ty), t_stop)
        c = torch.remainder(jx, nx) * ny + torch.remainder(jy, ny)
        a, b = tab.col_ab[c, 0], tab.col_ab[c, 1]
        seg = (torch.clamp(a - b * (sz + ddz * t), min=0.0)
               - torch.clamp(a - b * (sz + ddz * tn), min=0.0))
        tau_cl = torch.where(act, tau_cl + seg, tau_cl)
        n_walk += int(act.sum())
        act = act & ~(tn >= t_stop)
        go_x = act & (tx <= ty)
        go_y = act & ~(tx <= ty)
        jx = torch.where(go_x, jx + step_x, jx)
        jy = torch.where(go_y, jy + step_y, jy)
        tx = torch.where(go_x, face_x(jx), tx)
        ty = torch.where(go_y, face_y(jy), ty)
        t = torch.where(act, tn, t)
    tally.walk.add_(n_walk)
    tally.counts[4] += act.sum()
    hit = ~act
    tau_f = tau_cl / ddz
    if p.has_gas:  # closed form from the cumulative profile (:908-923)
        kz = ((sz - z0) * p[C_INV_DZ]).to(torch.int32).clamp(0, nz - 1)
        z_bot = z0 + kz.to(torch.float32) * p[C_DZ]
        kz = kz.long()
        tau_f = tau_f + (tab.qcb[kz] - tab.qz[kz] * (sz - z_bot)) / ddz

    # ---- contribution (:926-939) and the TOA exit pixel (:941-948) ----
    if p.le_rr:
        w_rrc = (w_p * zeta) * float(_F32(1.0 / np.pi))
        c_a = torch.where(hit & (tau_f < tau_free) & (u_i1 * zeta <= npf_pi),
                          w_rrc, 0.0)
        c_b = torch.where(hit & (tau_f < tau_max),
                          (w_p * npf) * torch.exp(-tau_f),
                          torch.where(hit & (tau_f - tau_max < tau_free),
                                      w_rrc, 0.0))
        contrib = torch.where(small, c_a, c_b)
    else:
        contrib = torch.where(hit, (w_p * npf) * torch.exp(-tau_f), 0.0)
    exf_x = torch.remainder(((sx + ddx * t_top) - x0) * inv_dx
                            + torch.sign(ddx) * _NDE, float(nx))
    exf_y = torch.remainder(((sy + ddy * t_top) - y0) * inv_dy
                            + torch.sign(ddy) * _NDE, float(ny))
    ex_col = (exf_x.to(torch.int32).clamp(0, nx - 1) * ny
              + exf_y.to(torch.int32).clamp(0, ny - 1))
    tally.img.index_add_(0, d_idx * nxy + ex_col.long(), contrib)


def col_launch_plain(st: ColState, tab: ColTables, prm: ColParams,
                     seed: int, step0: int, k_steps: int,
                     tally: ColTally) -> None:
    """``k_steps`` plain steps; adds [started, lanes with work left,
    lane-steps, ...] into ``tally.counts`` -- the contract of one kernel
    launch. Once no lane has a photon or quota the remaining steps would
    change nothing, and are not run (as the kernel's lanes stop)."""
    lane = torch.arange(st.x.shape[0], dtype=torch.int64, device=st.x.device)
    started = torch.zeros((), dtype=torch.int64, device=st.x.device)
    for k in range(k_steps):
        if not ((st.alive > 0) | (st.quota > 0)).any():
            break
        started = started + col_step_plain(st, tab, prm, lane, seed,
                                           step0 + k, tally)
    work = ((st.alive > 0) | (st.quota > 0)).sum()
    tally.counts[:2] += torch.stack([started, work])


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32


def _library():
    from mcbrat3d_tpu_torch import _build
    lib = _build.load("col_kernel")
    if not getattr(lib, "_mcb_typed", False):
        lib.col_kernel_num_params.restype = _I
        lib.col_kernel_num_params.argtypes = []
        lib.col_kernel_launch.restype = _I
        lib.col_kernel_launch.argtypes = (
            [_P] * 27 + [_I] * 9 + [_U, _U] + [_I] * 10 + [_P])
        lib.col_kernel_occupancy.restype = _I
        lib.col_kernel_occupancy.argtypes = [_I] * 10 + [_P]
        lib.col_walk_launch.restype = _I
        lib.col_walk_launch.argtypes = (
            [_P] * 4 + [_I] + [_P] * 9 + [_I] * 3 + [_U] + [_I] * 6 + [_P])
        if lib.col_kernel_num_params() != N_PARAMS:
            raise RuntimeError("csrc/col_kernel.cu and col_kernel.py "
                               "disagree on the parameter layout")
        lib._mcb_typed = True
    return lib


def _launch_cuda(st: ColState, tab: ColTables, prm: ColParams, seed: int,
                 step0: int, k_steps: int, tally: ColTally) -> None:
    global COL_LAUNCHES, COL_LE_LAUNCHES, COL_LW_LAUNCHES, COL_PX_LAUNCHES
    dev = st.x.device
    n = st.x.shape[0]
    check = rk._check
    for name in ColState.FLOAT_FIELDS:
        check(getattr(st, name), name, torch.float32, n, dev)
    for name in ColState.INT_FIELDS:
        check(getattr(st, name), name, torch.int32, n, dev)
    nxy = prm.nx * prm.ny
    n_blk = prm.nbx * prm.nby
    check(tab.col_hs, "col_hs", torch.float32, 2 * nxy, dev)
    check(tab.blocks, "blocks", torch.float32, max(1, 2 * n_blk), dev)
    inv_n = tab.inv_a0.numel()
    if not prm.analytic_hg and inv_n != prm.inv_n_steps:
        raise ValueError(f"inverse-CDF row has {inv_n} entries, expected "
                         f"one row of {prm.inv_n_steps}")
    check(tab.inv_a0, "inv_a0", torch.float32, inv_n, dev)
    check(tab.inv_dd, "inv_dd", torch.float32, inv_n, dev)
    n_q = prm.nz if prm.has_gas else 1
    check(tab.qz, "qz", torch.float32, n_q, dev)
    check(tab.qcb, "qcb", torch.float32, n_q, dev)
    check(prm.device_values, "params", torch.float32, N_PARAMS, dev)
    check(tally.acc, "acc", torch.float32, prm.n_acc, dev)
    check(tally.counts, "counts", torch.int64, N_COUNTS, dev)
    if prm.nz > MAX_NZ:
        raise ValueError(f"nz={prm.nz} > {MAX_NZ}: the kernel's profile "
                         "tally lives in shared memory")
    queue = tally.queue
    if prm.n_dirs:
        le.check_queue(queue, len(QUEUE_FLOATS), len(QUEUE_INTS),
                       n * k_steps, dev)
    emission = SOURCE_KINDS[prm.source_kind] == illumination.EMISSION
    n_em = nxy if emission else 1
    for name in ("em_prob", "em_alias", "em_halias"):
        check(getattr(tab, name), name, torch.float32, n_em, dev)
    check(tab.em_fcum, "em_fcum", torch.float32, prm.nz if emission else 1,
          dev)
    check(tab.albedo, "albedo", torch.float32, nxy if prm.has_px else 1,
          dev)
    if prm.lw and not emission:
        raise ValueError("lw pre-credits need the emission source")
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the queue's buffers (none on the flux path)
    q_ptrs = ([queue.f.data_ptr(), queue.i.data_ptr(), queue.ctl.data_ptr()]
              if prm.n_dirs else [0, 0, 0])
    ptrs = [prm.device_values, tab.col_hs, tab.blocks,
            tab.inv_a0, tab.inv_dd,
            *(getattr(st, k) for k in ColState.FLOAT_FIELDS),
            st.quota, st.alive, tally.acc, tally.counts, tab.qz]
    ptrs2 = [tab.em_prob, tab.em_alias, tab.em_halias, tab.em_fcum,
             tab.albedo]
    err = lib.col_kernel_launch(
        *(t.data_ptr() for t in ptrs), *q_ptrs,
        *(t.data_ptr() for t in ptrs2), n, prm.nx, prm.ny, prm.nz,
        prm.macro_factor, prm.nby, n_blk, prm.inv_n_steps, prm.n_acc,
        seed & 0xFFFF_FFFF, step0 & 0xFFFF_FFFF, k_steps,
        int(prm.analytic_hg), int(prm.need_vol), int(prm.use_rr),
        prm.source_kind, int(prm.has_gas), prm.n_dirs,
        queue.capacity if prm.n_dirs else 0, int(prm.lw), int(prm.has_px),
        stream)
    COL_LAUNCHES += 1
    if prm.n_dirs:
        COL_LE_LAUNCHES += 1
    if emission:
        COL_LW_LAUNCHES += 1
    if prm.has_px:
        COL_PX_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"col_kernel launch failed: CUDA error {err}")
    if prm.n_dirs:  # the launch's local estimates, on the same stream
        _walk_cuda(tab, prm, seed, queue, tally)


def _walk_cuda(tab: ColTables, prm: ColParams, seed: int,
               queue: le.EventQueue, tally: ColTally) -> None:
    """The walk kernel over the events ``queue`` holds from the last
    transport launch: every (event, direction) pair's local estimate into
    ``tally.img``, its walk iterations into ``tally.walk`` and its cut
    walks into ``tally.counts[4]``."""
    global COL_WALK_LAUNCHES
    dev = queue.f.device
    check = rk._check
    nxy = prm.nx * prm.ny
    if not 0 < prm.n_dirs <= le.MAX_KERNEL_DIRS:
        raise ValueError(f"{prm.n_dirs} radiance directions: the walk takes "
                         f"1 to {le.MAX_KERNEL_DIRS} per launch")
    le.check_queue(queue, len(QUEUE_FLOATS), len(QUEUE_INTS), 1, dev)
    check(prm.device_values, "params", torch.float32, N_PARAMS, dev)
    check(tab.dirs, "dirs", torch.float32, 4 * prm.n_dirs, dev)
    check(tab.col_ab, "col_ab", torch.float32, 2 * nxy, dev)
    n_q = prm.nz if prm.has_gas else 1
    check(tab.qz, "qz", torch.float32, n_q, dev)
    check(tab.qcb, "qcb", torch.float32, n_q, dev)
    if prm.le_fwd:
        n_f = tab.fwd_v0.numel()
        if n_f < rk.FWD_N_S:
            raise ValueError(f"forward row has {n_f} entries, expected "
                             f"at least {rk.FWD_N_S}")
        check(tab.fwd_v0, "fwd_v0", torch.float32, n_f, dev)
        check(tab.fwd_dd, "fwd_dd", torch.float32, n_f, dev)
    check(tally.img, "img", torch.float32, prm.n_img, dev)
    check(tally.counts, "counts", torch.int64, N_COUNTS, dev)
    check(tally.walk, "walk", torch.int64, 1, dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [prm.device_values, queue.f, queue.i, queue.ctl]
    ptrs2 = [tab.dirs, tab.col_ab, tab.fwd_v0, tab.fwd_dd, tab.qz, tab.qcb,
             tally.img, tally.counts, tally.walk]
    err = lib.col_walk_launch(
        *(t.data_ptr() for t in ptrs), queue.capacity,
        *(t.data_ptr() for t in ptrs2), prm.nx, prm.ny, prm.nz,
        seed & 0xFFFF_FFFF, prm.n_dirs, int(prm.le_rr), int(prm.le_fwd),
        rk.FWD_N_S, prm.k_walk, int(prm.has_gas), stream)
    COL_WALK_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"col_walk launch failed: CUDA error {err}")


def occupancy(prm: ColParams) -> dict:
    """The transport kernel's occupancy record for ``prm``'s instantiation
    and the shared-memory layout ``col_launch`` takes for it, on the
    current card (``rk.OCCUPANCY_KEYS``)."""
    out = (ctypes.c_int * len(rk.OCCUPANCY_KEYS))()
    err = _library().col_kernel_occupancy(
        prm.nz, prm.macro_factor, prm.nbx * prm.nby, prm.inv_n_steps,
        int(prm.analytic_hg), int(prm.need_vol), int(prm.use_rr),
        prm.source_kind, prm.n_dirs, int(prm.lw), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"col_kernel occupancy query failed: CUDA error "
                           f"{err}")
    return dict(zip(rk.OCCUPANCY_KEYS, out))


def col_launch(st: ColState, tab: ColTables, prm: ColParams, seed: int,
               step0: int, k_steps: int, tally: ColTally) -> None:
    """Advance every lane by ``k_steps`` steps: the CUDA kernel for state on
    a CUDA device, the plain PyTorch step for state on the CPU."""
    if st.x.is_cuda:
        _launch_cuda(st, tab, prm, seed, step0, k_steps, tally)
    elif st.x.device.type == "cpu":
        col_launch_plain(st, tab, prm, seed, step0, k_steps, tally)
    else:
        raise ValueError(f"no column kernel for device {st.x.device}")


# ---------------------------------------------------------------------------
# Batch entry points
# ---------------------------------------------------------------------------

def run_batch_col(domain: OpticalDomain, surface: Surface,
                  source: illumination.Source, seed: int,
                  ccfg, photons_per_lane: Optional[int] = None,
                  n_photons=None, use_russian_roulette: bool = True,
                  russian_roulette_weight: float = 1.0,
                  launch=col_launch, intensity_config=None,
                  intensity_dirs=None, lw_mode: bool = False) -> Tallies:
    """One photon batch through the column kernel (port of
    ``run_batch_pallas_col``): the unnormalized tallies, with the
    absorption per column in ``flux_absorbed``, its z marginal in
    ``absorption_profile`` and, with ``ccfg.vol_tally``, the 3D field in
    ``volume_absorption``; with ``intensity_config`` and
    ``intensity_dirs`` [3, n_dirs] (the caller's order) also the radiance
    image [nx, ny, n_dirs] in ``intensity``. With ``lw_mode`` and an
    emission source the absorption tallies are net of the births'
    pre-credits.

    ``ccfg`` is a ``rk.RecordConfig``, the launch geometry (rows of 128
    lanes, ``photons_per_lane`` photons each at most, steps per launch, the
    step cap) and whether the 3D field is tallied, or a
    ``rk.RefillSchedule``: the card's resident slots for this kernel
    instantiation (``occupancy``, or the schedule's own count), at most
    the batch's ``n_photons`` (required then), each starting its share of
    them in the kernel, in launches of ``k_steps``
    (``rk.resolve_schedule``). ``seed`` is
    the uint32 kernel seed; ``launch`` is ``col_launch`` (or, to compare
    the two on one device, ``col_launch_plain``). ``n_bad`` counts photons
    still alive at the step cap and walks cut by their bound (``n_cut``,
    0 in every eligible run); ``n_steps`` is launches x steps a launch."""
    icfg = intensity_config
    if icfg is None:
        reasons = col_ineligibility_reasons(
            domain, surface, source, lw_mode=lw_mode,
            compute_intensity=False, record_scattering_orders=0,
            use_ray_tracing=False, need_volume_absorption=ccfg.vol_tally)
    else:
        reasons = col_intensity_ineligibility_reasons(
            domain, surface, source, lw_mode, 0, False, icfg,
            intensity_dirs, ccfg.vol_tally)
    if reasons:
        raise NotImplementedError(
            "configuration outside the ported column kernel; failing "
            "predicates: " + "; ".join(reasons))
    dev = domain.device
    order = dirs = None
    if icfg is not None:
        order = col_dir_order(domain, intensity_dirs)
        dirs = intensity_dirs[:, list(order)]
    prm = ColParams.make(domain, surface, source, use_russian_roulette,
                         russian_roulette_weight, ccfg.vol_tally, icfg, dirs,
                         lw_mode=lw_mode)
    tab = ColTables.from_domain(
        domain, icfg, dirs, emission=source.kind == illumination.EMISSION,
        surface=surface)
    ccfg, photons_per_lane = rk.resolve_schedule(
        ccfg, n_photons, photons_per_lane, lambda: occupancy(prm), dev)
    quota0 = rk.initial_quota(ccfg.n_lanes, photons_per_lane, n_photons, dev)
    st = ColState.initial(quota0, prm[C_BETA_MAX], prm.nz)
    k = ccfg.steps_per_call
    tally = ColTally.zeros(prm, dev, queue_capacity=ccfg.n_lanes * k)
    n_started, n_calls, lane_steps, n_events = rk.relaunch_loop(
        st, tally.counts,
        lambda step0: launch(st, tab, prm, seed, step0, k, tally),
        k, ccfg.max_steps, n_per_launch=4)
    if tally.queue is not None:
        tally.queue.check()
    nx, ny, nz = domain.grid.shape
    nxy = nx * ny
    acc = tally.acc
    profile = acc[3 * nxy:3 * nxy + nz]
    if prm.lw:  # the births' pre-credits, kept in a row of their own
        profile = profile + acc[prm.off_pre:prm.off_pre + nz]
    intensity = None
    n_cut = int(tally.counts[4])
    if icfg is not None:
        img = tally.img.reshape(prm.n_dirs, nxy)
        back = [0] * prm.n_dirs  # march index of each caller's direction
        for j, d in enumerate(order):
            back[d] = j
        intensity = img[back].T.reshape(nx, ny, prm.n_dirs)
    return Tallies(
        flux_up=acc[:nxy].reshape(nx, ny),
        flux_down=acc[nxy:2 * nxy].reshape(nx, ny),
        flux_absorbed=acc[2 * nxy:3 * nxy].reshape(nx, ny),
        volume_absorption=(acc[prm.off_vol:prm.off_pre].reshape(nx, ny, nz)
                           if ccfg.vol_tally else None),
        absorption_profile=profile,
        intensity=intensity,
        n_photons=n_started, n_bad=int(st.alive.sum()) + n_cut,
        n_steps=n_calls * k, n_lane_steps=lane_steps, n_cut=n_cut,
        n_le_events=n_events, n_walk=int(tally.walk),
        n_atm_births=int(tally.counts[5]))


def run_batch_col_tallies(domain, surface, source, seed: int, config,
                          n_photons=None, launch=col_launch,
                          intensity_config=None, intensity_dirs=None,
                          ccfg=None) -> Tallies:
    """``run_batch``-compatible entry (port of
    ``run_batch_pallas_col_tallies``), with the 3D field when
    ``config.need_volume_absorption`` and the emission pre-credits with
    ``config.lw_mode``. A flux run takes the refill schedule by default
    (``rk.RefillSchedule``: the card's resident slots, launches of
    ``rk.REFILL_STEPS`` steps, ``config.max_steps`` rounded up to whole
    launches), or the launch geometry ``ccfg`` (``rk.jax_geometry(config)``
    is the JAX package's: at most 512 rows of 128 lanes, 128 steps a
    launch, so that its lanes carry the JAX kernel's photons); the 3D
    field is ``config``'s choice whatever ``ccfg`` says. A radiance
    run takes the JAX package's geometry at most 32 rows (4,096 lanes) and
    folds the rest into per-lane quota (pallas_col.py:1514-1525)."""
    vol = config.need_volume_absorption
    ppl = None
    if intensity_config is not None:
        ccfg, ppl = rk.config_for(config.n_lanes, config.photons_per_lane,
                                  config.max_steps, vol_tally=vol)
        rows = min(ccfg.rows, rk.RADIANCE_ROWS)
        ppl = -(-config.photons_per_batch // (rows * rk.LANES_PER_ROW))
        ccfg = dataclasses.replace(ccfg, rows=rows)
    elif ccfg is None:
        ccfg = rk.RefillSchedule(config.max_steps, vol_tally=vol)
    else:
        ccfg = dataclasses.replace(ccfg, vol_tally=vol)
    if n_photons is None:
        n_photons = config.photons_per_batch
    return run_batch_col(
        domain, surface, source, seed, ccfg, ppl, n_photons=n_photons,
        use_russian_roulette=config.use_russian_roulette,
        russian_roulette_weight=config.russian_roulette_weight,
        launch=launch, intensity_config=intensity_config,
        intensity_dirs=intensity_dirs, lw_mode=config.lw_mode)
