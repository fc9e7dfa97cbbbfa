"""Column-template kernel (K3): the CUDA kernel, its plain PyTorch step and
the batch entry points, for the flux path.

PyTorch counterpart of ``mcbrat3d_tpu.transport.pallas_col``
(``pallas_col_eligible``, ``_build_kernel_col``, ``run_batch_pallas_col``,
``run_batch_pallas_col_tallies``) for Landsat-scale domains whose
extinction is a column template,

    beta(x, y, z) = col_scale[col] * (iz < col_height[col]),

so two per-column values (at most 16,384 columns) carry a field of
millions of cells. Every lane carries one photon through ``steps_per_call``
steps per launch: refill from a directional, random-azimuth or flux
source; a Woodcock jump against the carried xy-block majorant below the
block's cloud-top plane and a geometric advance above it, clipped at the
block faces (clamped to the domain edge) and, descending, at the plane; the
column gather; the null-collision test; absorption by the uniform ssa;
Russian roulette; analytic HG or single-row inverse-CDF scattering;
Lambertian reflection; and the tallies of flux up/down and absorption per
column, the absorption z profile and, optionally, the 3D absorption field.

Two implementations of one launch:

* ``csrc/col_kernel.cu``, one CUDA thread per lane (``_launch_cuda``);
* ``col_step_plain``, the same step on ``[n_lanes]`` tensors, operation for
  operation the JAX kernel's float32 arithmetic (``_build_kernel_col``
  :375-744, 974-1085) without its TPU workarounds: the column fields are
  plain float32 arrays (no bf16 hi/lo split), the gathers are indexed
  loads (no bilinear one-hot products) and the tallies add exact float32
  values (the JAX kernel rounds exit weights to bf16 and absorption to a
  bf16 hi/lo pair).

``col_launch`` sends CUDA tensors to the kernel and CPU tensors to the
plain step; there is no fallback between them. Both draw the counter
uniforms of ``core.rng`` at K3's sites, so for one seed they follow the
JAX kernel's photon paths.

Not ported (``col_ineligibility_reasons`` names each): the two-component
gas template, column BBEmission and LW pre-credits, the per-pixel
Lambertian albedo and the slab-scan radiance.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from mcbrat3d_tpu_torch.core import rng
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport import record_kernel as rk
from mcbrat3d_tpu_torch.transport.integrator import (Tallies,
                                                     rotate_direction,
                                                     sample_hg_cos)

# Envelope shared with the JAX column kernel (pallas_col.MAX_COLS,
# MAX_VOL_CELLS and the nz <= 128 profile; its phase row has the record
# kernel's rk.MAX_INV_ENTRIES bound).
MAX_COLS = 128 * 128
MAX_VOL_CELLS = 128 * 128 * 128
MAX_NZ = 128

# Kernel launches made by ``_launch_cuda`` in this process.
COL_LAUNCHES = 0

# Draw sites of K3 (pallas_col.py:403-650): refill x/y, the source azimuth
# (random azimuth) or mu then azimuth (flux), tau, collision, angle,
# rotation azimuth, roulette.
SITE_X, SITE_Y, SITE_SRC, SITE_TAU, SITE_COLLIDE = 0, 1, 2, 3, 4
SITE_ANGLE, SITE_PHI, SITE_ROULETTE, SITE_SRC_PHI = 5, 6, 7, 9

# Source kinds of the kernel (csrc/col_kernel.cu SRC_*).
SOURCE_KINDS = (illumination.DIRECTIONAL, illumination.RANDOM_AZIMUTH,
                illumination.FLUX)

# Slots of the float32 parameter vector (csrc/col_kernel.cu C_*).
(C_BETA_MAX, C_ALBEDO, C_SMU, C_SUX, C_SUY, C_RR_W, C_HALF_RR, C_X0, C_LX,
 C_Y0, C_LY, C_Z0, C_LZ, C_SSA, C_G, C_INV_DX, C_INV_DY, C_INV_DZ, C_DZ,
 C_ZMAX, C_ZTOP, C_ZBOT, C_BXW, C_BYW, C_NUDGE, C_TWO_PI, N_PARAMS) = range(27)

_TINY = rk._TINY
_BIG = 3e38
_F32 = np.float32


def col_ineligibility_reasons(domain: OpticalDomain, surface: Surface,
                              source: illumination.Source, lw_mode: bool,
                              compute_intensity: bool,
                              record_scattering_orders: int,
                              use_ray_tracing: bool,
                              need_volume_absorption: bool) -> list:
    """Names of every failing column-kernel predicate (empty = eligible):
    port of ``pallas_col.pallas_col_eligible``, with the parts of K3 that
    are not ported named as such."""
    nx, ny, nz = domain.grid.shape
    inv = domain.tables.inverse
    ncomp = domain.n_components
    checks = (
        ("domain is not a column template (beta = col_scale[col] * "
         "(iz < col_height[col]))", domain.col_template),
        ("two-component gas template (col_qz, col_cloud, col_inv_row) is "
         "not ported yet", ncomp != 2),
        (f"n_components={ncomp} > 2", ncomp <= 2),
        ("phase is neither one uniform analytic HG nor a single-row "
         f"inverse-CDF table of <= {rk.MAX_INV_ENTRIES} entries",
         (domain.all_hg and domain.uniform_hg)
         or (inv.shape[0] == 1 and inv.numel() <= rk.MAX_INV_ENTRIES)),
        ("single-scattering albedo is not uniform", domain.uniform_ssa),
        ("irregular grid spacing",
         domain.grid.xy_regular and domain.grid.z_regular),
        ("surface is not uniform Lambertian (the per-pixel Lambertian "
         "albedo, has_px, is not ported yet)", surface.is_uniform_lambertian),
        ("emission source (column BBEmission, col_em_*) is not ported yet",
         source.kind != illumination.EMISSION),
        (f"source kind {source.kind!r} is not taken by the column kernel",
         source.kind in SOURCE_KINDS + (illumination.EMISSION,)),
        ("lw_mode (column BBEmission and LW pre-credits) is not ported yet",
         not lw_mode),
        ("compute_intensity (column-kernel slab-scan radiance) is not "
         "ported yet", not compute_intensity),
        ("record_scattering_orders > 0", record_scattering_orders == 0),
        ("use_ray_tracing=True (the kernel is max-cross-section only)",
         not use_ray_tracing),
        (f"3D absorption tally over {nx * ny * nz} cells > {MAX_VOL_CELLS}",
         not need_volume_absorption or nx * ny * nz <= MAX_VOL_CELLS),
        (f"nx*ny={nx * ny} > {MAX_COLS} columns", nx * ny <= MAX_COLS),
        (f"nz={nz} > {MAX_NZ}", nz <= MAX_NZ),
    )
    return [name for name, ok in checks if not ok]


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


@dataclasses.dataclass(frozen=True)
class ColTables:
    """Device tables the step reads: the column fields, the xy-block table
    [nbx*nby, 2] (majorant scale, cloud-top height) flattened, and the
    single inverse-CDF row with its forward differences (``rk.inverse_table``);
    one-element placeholders where unused."""

    col_scale: torch.Tensor
    col_height: torch.Tensor
    blocks: torch.Tensor
    inv_a0: torch.Tensor
    inv_dd: torch.Tensor

    @staticmethod
    def from_domain(domain: OpticalDomain) -> "ColTables":
        zero = torch.zeros(1, dtype=torch.float32, device=domain.device)
        a0, dd = (zero, zero) if domain.all_hg else rk.inverse_table(domain)
        blocks = (domain.macro_table.reshape(-1).contiguous()
                  if domain.macro_factor > 0 else zero)
        return ColTables(col_scale=domain.col_scale.contiguous(),
                         col_height=domain.col_height.contiguous(),
                         blocks=blocks, inv_a0=a0, inv_dd=dd)


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

    def __getitem__(self, slot: int) -> float:
        return float(self.values[slot])

    @property
    def n_acc(self) -> int:
        """Tally entries: [up nxy | down nxy | absorbed nxy | profile nz |
        3D field nxy*nz, row-major (column, level), with need_vol]."""
        nxy = self.nx * self.ny
        return 3 * nxy + self.nz + (nxy * self.nz if self.need_vol else 0)

    @staticmethod
    def make(domain: OpticalDomain, surface: Surface,
             source: illumination.Source, use_russian_roulette: bool,
             russian_roulette_weight: float, need_vol: bool) -> "ColParams":
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
        rec0 = domain.cell_records[0].cpu().numpy()
        vals = np.zeros(N_PARAMS, np.float32)
        vals[[C_BETA_MAX, C_ALBEDO, C_SMU, C_SUX, C_SUY, C_RR_W,
              C_HALF_RR]] = (beta_max, f(surface.albedo), smu,
                             sth * np.cos(sphi), sth * np.sin(sphi), rr_w,
                             f(0.5) * rr_w)
        vals[[C_X0, C_LX, C_Y0, C_LY, C_Z0, C_LZ]] = (
            xe[0], lx, ye[0], ly, ze[0], lz)
        # one component: ssa at record slot 3, HG g at slot 5
        vals[[C_SSA, C_G]] = (rec0[3], rec0[5])
        vals[[C_INV_DX, C_INV_DY, C_INV_DZ, C_DZ]] = (
            f(nx) / lx, f(ny) / ly, f(nz) / lz, lz / f(nz))
        vals[[C_ZMAX, C_ZTOP, C_ZBOT]] = (z_max, z_max - z_eps,
                                          ze[0] + z_eps)
        vals[[C_BXW, C_BYW, C_NUDGE, C_TWO_PI]] = (
            bxw, byw, f(1e-5) * min(bxw, byw), f(2.0 * np.pi))
        return ColParams(
            values=vals,
            device_values=torch.as_tensor(vals, device=domain.device),
            nx=nx, ny=ny, nz=nz, macro_factor=mf,
            nbx=-(-nx // mf) if mf else 0, nby=-(-ny // mf) if mf else 0,
            analytic_hg=bool(domain.all_hg),
            inv_n_steps=int(domain.tables.inverse.shape[1]),
            use_rr=bool(use_russian_roulette), need_vol=bool(need_vol),
            source_kind=SOURCE_KINDS.index(source.kind))


@dataclasses.dataclass(frozen=True)
class ColTally:
    """What a launch adds into: ``acc`` the tallies [prm.n_acc] f32 and
    ``counts`` int32 [photons started, lanes with work left, lane-steps run
    with a live photon] (``rk.relaunch_loop`` layout)."""

    acc: torch.Tensor
    counts: torch.Tensor

    @staticmethod
    def zeros(prm: ColParams, device) -> "ColTally":
        return ColTally(
            acc=torch.zeros(prm.n_acc, dtype=torch.float32, device=device),
            counts=torch.zeros(3, dtype=torch.int32, device=device))


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
    x = torch.where(need, x0 + u(ctr, SITE_X) * lx, x)
    y = torch.where(need, y0 + u(ctr, SITE_Y) * ly, y)
    z = torch.where(need, p[C_ZTOP], z)
    kind = SOURCE_KINDS[p.source_kind]
    if kind == illumination.DIRECTIONAL:
        s_mu = torch.full_like(x, -p[C_SMU])
        sux = torch.full_like(x, p[C_SUX])
        suy = torch.full_like(x, p[C_SUY])
    else:
        if kind == illumination.RANDOM_AZIMUTH:
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
    tally.counts[2] += alive.sum().to(torch.int32)
    # fresh photons carry the (always valid) global ceiling
    bls = torch.where(need, beta_max, bls)
    blh = torch.where(need, float(nz), blh)

    # ---- Woodcock jump against the carried block ceiling ----
    tau = -torch.log1p(-u(ctr, SITE_TAU))
    ztop_m = z0 + blh * p[C_DZ]          # block cloud-top plane
    above = z >= ztop_m
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

    # ---- column gather ----
    col_l = col.long()
    beta = torch.where(iz.to(torch.float32) < tab.col_height[col_l],
                       tab.col_scale[col_l], 0.0)

    # ---- block-majorant gather at the destination ----
    if mf > 0:
        bidx = ((ix // mf) * p.nby + iy // mf).long()
        bls = torch.where(moved, tab.blocks[2 * bidx], bls)
        blh = torch.where(moved, tab.blocks[2 * bidx + 1], blh)

    # null-collision test against the ceiling this jump sampled with
    real = collide & (u(ctr, SITE_COLLIDE) * ceiling < beta)
    ssa = p[C_SSA]
    absorbed = torch.where(real, w * (1.0 - ssa), 0.0)
    w = torch.where(real, w * ssa, w)

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
    ox, oy, oz = rotate_direction(ux, uy, uz, cos_t, phi_rot)
    ux = torch.where(scatter, ox, ux)
    uy = torch.where(scatter, oy, uy)
    uz = torch.where(scatter, oz, uz)

    # ---- Lambertian surface reflection ----
    w_down = w
    w_refl = w_down * p[C_ALBEDO]
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

    # ---- tallies: exits at the crossing column, absorption at the
    # collision column, its level and (need_vol) its cell ----
    t_val = torch.where(exit_top, w, torch.where(exit_bot, w_down, absorbed))
    t_val = torch.where(exits | real, t_val, 0.0)
    t_idx = torch.where(exits, torch.where(exit_top, col_e, nxy + col_e),
                        2 * nxy + col)
    acc = tally.acc
    acc.index_add_(0, t_idx.long(), t_val)
    acc.index_add_(0, (3 * nxy + iz).long(), absorbed)
    if p.need_vol:
        acc.index_add_(0, 3 * nxy + nz + col_l * nz + iz.long(), absorbed)

    st.x, st.y, st.z, st.ux, st.uy, st.uz, st.w = x, y, z, ux, uy, uz, w
    st.bls, st.blh = bls, blh
    st.quota = quota
    st.alive = alive.to(torch.int32)
    return started


def col_launch_plain(st: ColState, tab: ColTables, prm: ColParams,
                     seed: int, step0: int, k_steps: int,
                     tally: ColTally) -> None:
    """``k_steps`` plain steps; adds [started, lanes with work left,
    lane-steps] into ``tally.counts`` -- the contract of one kernel
    launch."""
    lane = torch.arange(st.x.shape[0], dtype=torch.int64, device=st.x.device)
    started = torch.zeros((), dtype=torch.int64, device=st.x.device)
    for k in range(k_steps):
        started = started + col_step_plain(st, tab, prm, lane, seed,
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
    lib = _build.load("col_kernel")
    if not getattr(lib, "_mcb_typed", False):
        lib.col_kernel_num_params.restype = _I
        lib.col_kernel_num_params.argtypes = []
        lib.col_kernel_launch.restype = _I
        lib.col_kernel_launch.argtypes = (
            [_P] * 19 + [_I] * 9 + [_U, _U] + [_I] * 5 + [_P])
        if lib.col_kernel_num_params() != N_PARAMS:
            raise RuntimeError("csrc/col_kernel.cu and col_kernel.py "
                               "disagree on the parameter layout")
        lib._mcb_typed = True
    return lib


def _launch_cuda(st: ColState, tab: ColTables, prm: ColParams, seed: int,
                 step0: int, k_steps: int, tally: ColTally) -> None:
    global COL_LAUNCHES
    dev = st.x.device
    n = st.x.shape[0]
    check = rk._check
    for name in ColState.FLOAT_FIELDS:
        check(getattr(st, name), name, torch.float32, n, dev)
    for name in ColState.INT_FIELDS:
        check(getattr(st, name), name, torch.int32, n, dev)
    nxy = prm.nx * prm.ny
    n_blk = prm.nbx * prm.nby
    check(tab.col_scale, "col_scale", torch.float32, nxy, dev)
    check(tab.col_height, "col_height", torch.float32, nxy, dev)
    check(tab.blocks, "blocks", torch.float32, max(1, 2 * n_blk), dev)
    inv_n = tab.inv_a0.numel()
    if not prm.analytic_hg and inv_n != prm.inv_n_steps:
        raise ValueError(f"inverse-CDF row has {inv_n} entries, expected "
                         f"one row of {prm.inv_n_steps}")
    check(tab.inv_a0, "inv_a0", torch.float32, inv_n, dev)
    check(tab.inv_dd, "inv_dd", torch.float32, inv_n, dev)
    check(prm.device_values, "params", torch.float32, N_PARAMS, dev)
    check(tally.acc, "acc", torch.float32, prm.n_acc, dev)
    check(tally.counts, "counts", torch.int32, 3, dev)
    if prm.nz > MAX_NZ:
        raise ValueError(f"nz={prm.nz} > {MAX_NZ}: the kernel's profile "
                         "tally lives in shared memory")
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [prm.device_values, tab.col_scale, tab.col_height, tab.blocks,
            tab.inv_a0, tab.inv_dd,
            *(getattr(st, k) for k in ColState.FLOAT_FIELDS),
            st.quota, st.alive, tally.acc, tally.counts]
    err = lib.col_kernel_launch(
        *(t.data_ptr() for t in ptrs), n, prm.nx, prm.ny, prm.nz,
        prm.macro_factor, prm.nby, n_blk, prm.inv_n_steps, prm.n_acc,
        seed & 0xFFFF_FFFF, step0 & 0xFFFF_FFFF, k_steps,
        int(prm.analytic_hg), int(prm.need_vol), int(prm.use_rr),
        prm.source_kind, stream)
    COL_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"col_kernel launch failed: CUDA error {err}")


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
                  ccfg: rk.RecordConfig, photons_per_lane: int,
                  n_photons=None, use_russian_roulette: bool = True,
                  russian_roulette_weight: float = 1.0,
                  launch=col_launch) -> Tallies:
    """One photon batch through the column kernel (port of
    ``run_batch_pallas_col``'s flux path): the unnormalized tallies, with
    the absorption per column in ``flux_absorbed``, its z marginal in
    ``absorption_profile`` and, with ``ccfg.vol_tally``, the 3D field in
    ``volume_absorption``.

    ``ccfg`` gives the launch geometry (rows of 128 lanes, steps per
    launch, the step cap) and whether the 3D field is tallied; ``seed`` is
    the uint32 kernel seed; ``launch`` is ``col_launch`` (or, to compare
    the two on one device, ``col_launch_plain``). ``n_bad`` counts photons
    still alive at the step cap."""
    reasons = col_ineligibility_reasons(
        domain, surface, source, lw_mode=False, compute_intensity=False,
        record_scattering_orders=0, use_ray_tracing=False,
        need_volume_absorption=ccfg.vol_tally)
    if reasons:
        raise NotImplementedError(
            "configuration outside the ported column kernel; failing "
            "predicates: " + "; ".join(reasons))
    dev = domain.device
    prm = ColParams.make(domain, surface, source, use_russian_roulette,
                         russian_roulette_weight, ccfg.vol_tally)
    tab = ColTables.from_domain(domain)
    quota0 = rk.initial_quota(ccfg.n_lanes, photons_per_lane, n_photons, dev)
    st = ColState.initial(quota0, prm[C_BETA_MAX], prm.nz)
    tally = ColTally.zeros(prm, dev)
    k = ccfg.steps_per_call
    n_started, n_calls, lane_steps, _ = rk.relaunch_loop(
        st, tally.counts,
        lambda step0: launch(st, tab, prm, seed, step0, k, tally),
        k, ccfg.max_steps)
    nx, ny, nz = domain.grid.shape
    nxy = nx * ny
    acc = tally.acc
    return Tallies(
        flux_up=acc[:nxy].reshape(nx, ny),
        flux_down=acc[nxy:2 * nxy].reshape(nx, ny),
        flux_absorbed=acc[2 * nxy:3 * nxy].reshape(nx, ny),
        volume_absorption=(acc[3 * nxy + nz:].reshape(nx, ny, nz)
                           if ccfg.vol_tally else None),
        absorption_profile=acc[3 * nxy:3 * nxy + nz],
        n_photons=n_started, n_bad=int(st.alive.sum()),
        n_steps=n_calls * k, n_lane_steps=lane_steps)


def run_batch_col_tallies(domain, surface, source, seed: int, config,
                          n_photons=None, launch=col_launch) -> Tallies:
    """``run_batch``-compatible entry (port of
    ``run_batch_pallas_col_tallies`` for flux runs): the record kernel's
    launch geometry (``rk.config_for``: at most 512 rows of 128 lanes, the
    rest of the batch folded into per-lane quota) and the 3D field when
    ``config.need_volume_absorption``."""
    ccfg, ppl = rk.config_for(config.n_lanes, config.photons_per_lane,
                              config.max_steps,
                              vol_tally=config.need_volume_absorption)
    if n_photons is None:
        n_photons = config.photons_per_batch
    return run_batch_col(
        domain, surface, source, seed, ccfg, ppl, n_photons=n_photons,
        use_russian_roulette=config.use_russian_roulette,
        russian_roulette_weight=config.russian_roulette_weight,
        launch=launch)
