"""Record kernel, flux path: the CUDA kernel, its plain PyTorch step and the
relaunch loop around them.

PyTorch counterpart of ``mcbrat3d_tpu.transport.pallas_kernel`` for the
flux path of the record megakernel (``_build_kernel``, ``_make_launch``,
``run_batch_pallas``, ``run_batch_pallas_tallies``). Every lane carries one
photon through ``steps_per_call`` transport steps per launch: refill from
the source, Woodcock jump against the (optional two-level macro-cell)
majorant, record fetch, null-collision test, absorption weight, Russian
roulette, HG or inverse-CDF scatter + rotation, Lambertian reflection and
the fused tally of flux up/down per column and absorption per column
(``vol_tally=False``, the JAX ``flux_abs_2d``) or per cell.

Two implementations of one launch:

* ``csrc/record_kernel.cu``, one CUDA thread per lane (``_launch_cuda``);
* ``record_step_plain``, the same step on ``[n_lanes]`` tensors with masked
  ``torch.where`` selects, bit-faithful to the JAX kernel's float32
  arithmetic on the CPU.

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
from mcbrat3d_tpu_torch.domain.domain import OpticalDomain
from mcbrat3d_tpu_torch.physics.surface import Surface
from mcbrat3d_tpu_torch.sources import illumination
from mcbrat3d_tpu_torch.transport.integrator import (Tallies,
                                                     rotate_direction,
                                                     sample_hg_cos)

LANES_PER_ROW = 128
# Envelope shared with the JAX record kernel, so both dispatch the same
# domains (pallas_kernel.MAX_CELLS / MAX_INV_ENTRIES).
MAX_CELLS = 288 * 128
MAX_INV_ENTRIES = 1024 * 128
# The dense tiled kernel (K5) takes eligible domains past this many cells.
TILE_MIN_CELLS = 128 * 128

# Kernel launches made by ``_launch_cuda`` in this process.
LAUNCHES = 0

# Slots of the float32 parameter vector (csrc/record_kernel.cu P_*).
(P_BETA_MAX, P_INV_BETA_MAX, P_ALBEDO, P_SMU, P_SUX, P_SUY, P_RR_W,
 P_X0, P_LX, P_Y0, P_LY, P_Z0, P_LZ, P_INV_DX, P_INV_DY, P_INV_DZ,
 P_ZMAX, P_ZEPS, P_BXW, P_BYW, P_BZW, P_NUDGE, P_TWO_PI, P_HALF_RR,
 P_ZTOP, P_ZBOT, N_PARAMS) = range(27)

_TINY = 1e-30


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


def ineligibility_reasons(domain: OpticalDomain, surface: Surface,
                          source: illumination.Source,
                          lw_mode: bool, compute_intensity: bool,
                          record_scattering_orders: int,
                          use_ray_tracing: bool) -> list:
    """Names of every failing record-kernel predicate (empty = eligible).

    Port of ``pallas_kernel.ineligibility_reasons`` restricted to what the
    port's kernel covers: one component, a uniform Lambertian surface and
    a directional source, flux tallies only."""
    nx, ny, nz = domain.grid.shape
    n_cells = nx * ny * nz
    vol_base = -(-2 * nx * ny // 128) * 128
    inv_size = domain.tables.inverse.numel()
    checks = (
        (f"inverse-CDF table has {inv_size} entries > {MAX_INV_ENTRIES}",
         domain.all_hg or inv_size <= MAX_INV_ENTRIES),
        (f"n_components={domain.n_components} > 1 (multi-component "
         "records are not ported yet)", domain.n_components == 1),
        ("irregular grid spacing",
         domain.grid.xy_regular and domain.grid.z_regular),
        ("surface is not uniform Lambertian (RPV and per-pixel albedo "
         "are not ported yet)", surface.is_uniform_lambertian),
        (f"source kind {source.kind!r} not ported (directional only)",
         source.kind == illumination.DIRECTIONAL),
        ("lw_mode (emission is not ported yet)", not lw_mode),
        ("compute_intensity (radiance, K2, is not ported yet)",
         not compute_intensity),
        ("record_scattering_orders > 0", record_scattering_orders == 0),
        ("use_ray_tracing=True (the kernel is max-cross-section only)",
         not use_ray_tracing),
        (f"n_cells={n_cells} > {MAX_CELLS}", n_cells <= MAX_CELLS),
        (f"tally span {vol_base + n_cells} > {MAX_CELLS}",
         vol_base + n_cells <= MAX_CELLS),
    )
    return [name for name, ok in checks if not ok]


# ---------------------------------------------------------------------------
# Kernel inputs
# ---------------------------------------------------------------------------

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
    """Device tables the step reads: records [n_cells, stride] f32 and
    the flat inverse-CDF angles with their forward differences."""

    records: torch.Tensor
    inv_a0: torch.Tensor
    inv_dd: torch.Tensor

    @staticmethod
    def from_domain(domain: OpticalDomain) -> "RecordTables":
        rec = domain.cell_records.contiguous()
        if domain.all_hg:
            a0 = dd = torch.zeros(1, dtype=torch.float32, device=rec.device)
        else:
            # same float32 deltas as pallas_kernel._pack_inverse_table
            a0 = domain.tables.inverse.reshape(-1).contiguous()
            dd = (torch.cat([a0[1:], a0[-1:]]) - a0).contiguous()
        return RecordTables(records=rec, inv_a0=a0, inv_dd=dd)


@dataclasses.dataclass(frozen=True)
class RecordParams:
    """Scalars of one batch: ``values`` is the float32 parameter vector
    (P_* slots, computed in float32 as the JAX launch computes them),
    ``device_values`` its copy on the kernel's device."""

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

    def __getitem__(self, slot: int) -> float:
        return float(self.values[slot])

    @property
    def n_acc(self) -> int:
        """Tally entries: [up nxy | down nxy | absorbed nxy or nxyz]."""
        nxy = self.nx * self.ny
        return 2 * nxy + (nxy * self.nz if self.vol_tally else nxy)

    @staticmethod
    def make(domain: OpticalDomain, surface: Surface,
             source: illumination.Source, use_russian_roulette: bool,
             russian_roulette_weight: float,
             vol_tally: bool) -> "RecordParams":
        f = np.float32
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
        ncomp = domain.n_components
        return RecordParams(
            values=vals,
            device_values=torch.as_tensor(vals, device=domain.device),
            nx=nx, ny=ny, nz=nz, macro_factor=mf,
            stride=2 + 4 * ncomp, off_ssa=2 + ncomp,
            off_f2=(2 + 3 * ncomp if domain.all_hg else 2 + 2 * ncomp),
            analytic_hg=bool(domain.all_hg),
            inv_n_steps=int(domain.tables.inverse.shape[1]),
            use_rr=bool(use_russian_roulette), vol_tally=bool(vol_tally))


# ---------------------------------------------------------------------------
# Plain PyTorch step
# ---------------------------------------------------------------------------

def record_step_plain(st: RecordState, tab: RecordTables, prm: RecordParams,
                      lane: torch.Tensor, seed: int, ctr: int,
                      acc: torch.Tensor) -> torch.Tensor:
    """One transport step for every lane; returns the photons started.

    ``lane`` holds the int64 lane indices, ``ctr`` the step counter;
    ``acc`` ([prm.n_acc] f32) receives this step's tally. Operation for
    operation the JAX kernel's float32 arithmetic (pallas_kernel.py
    _build_kernel, flux sections)."""
    p = prm
    u = rng.make_uniform(lane, seed)
    x0, lx, y0, ly = p[P_X0], p[P_LX], p[P_Y0], p[P_LY]
    z0, z_max, beta_max = p[P_Z0], p[P_ZMAX], p[P_BETA_MAX]
    nx, ny, nz = p.nx, p.ny, p.nz
    nxy = nx * ny
    macro = p.macro_factor > 0
    x, y, z, ux, uy, uz, w, bl = (st.x, st.y, st.z, st.ux, st.uy, st.uz,
                                  st.w, st.bl)

    # ---- refill dead lanes from the source ----
    alive = st.alive > 0
    need = ~alive & (st.quota > 0)
    x = torch.where(need, x0 + u(ctr, rng.SITE_X) * lx, x)
    y = torch.where(need, y0 + u(ctr, rng.SITE_Y) * ly, y)
    z = torch.where(need, p[P_ZTOP], z)
    ux = torch.where(need, p[P_SUX], ux)
    uy = torch.where(need, p[P_SUY], uy)
    uz = torch.where(need, -p[P_SMU], uz)
    w = torch.where(need, 1.0, w)
    alive = alive | need
    quota = st.quota - need.to(torch.int32)
    started = need.sum()

    # ---- Woodcock jump ----
    tau = -torch.log1p(-u(ctr, rng.SITE_TAU))
    if macro:
        bl = torch.where(need, beta_max, bl)

        def face(pos, p0, d, bw, length):
            t = (torch.clamp((torch.floor((pos - p0) / bw)
                              + (d >= 0).to(torch.float32)) * bw,
                             0.0, length) + p0) - pos
            return torch.where(d.abs() > 1e-12,
                               t / torch.where(d == 0, 1.0, d), 3e38)

        t_raw = torch.minimum(
            face(x, x0, ux, p[P_BXW], lx),
            torch.minimum(face(y, y0, uy, p[P_BYW], ly),
                          face(z, z0, uz, p[P_BZW], p[P_LZ])))
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
    # null-collision test against the majorant this step sampled with,
    # then carry the destination block's majorant
    ceiling = bl if macro else beta_max
    real = collide & (u(ctr, rng.SITE_COLLIDE) * ceiling < beta)
    if macro:
        bl = torch.where(moved, rec[:, 1], bl)
    absorbed = torch.where(real, w * (1.0 - ssa), 0.0)
    w = torch.where(real, w * ssa, w)

    # ---- Russian roulette ----
    if p.use_rr:
        rr_w = p[P_RR_W]
        play = real & (w < p[P_HALF_RR])
        survive = u(ctr, rng.SITE_ROULETTE) < w / rr_w
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

    # ---- Lambertian reflection ----
    w_down = w
    mu_new = torch.sqrt(torch.clamp(u_ang, min=1e-12))
    sin_new = torch.sqrt(torch.clamp(1.0 - mu_new * mu_new, min=0.0))
    w_refl = w_down * p[P_ALBEDO]
    died_surface = exit_bot & (w_refl <= _TINY)
    reflected = exit_bot & ~died_surface
    x = torch.where(exit_bot, xe, torch.where(moved, xc, x))
    y = torch.where(exit_bot, ye, torch.where(moved, yc, y))
    z = torch.where(exit_bot, p[P_ZBOT], torch.where(moved, zc, z))
    ux = torch.where(reflected, sin_new * torch.cos(phi_rot), ux)
    uy = torch.where(reflected, sin_new * torch.sin(phi_rot), uy)
    uz = torch.where(reflected, mu_new, uz)
    w = torch.where(reflected, w_refl, w)
    if macro:
        bl = torch.where(exit_bot, beta_max, bl)
    alive = alive & ~exit_top & ~died_weight & ~died_surface

    # ---- fused tally: one entry per lane (exit or absorption) ----
    t_val = torch.where(exit_top, w, torch.where(exit_bot, w_down, absorbed))
    t_val = torch.where(exits | real, t_val, 0.0)
    t_idx = torch.where(exits, torch.where(exit_top, col_e, nxy + col_e),
                        2 * nxy + (cell if p.vol_tally else col_c))
    acc.index_add_(0, t_idx.long(), t_val)

    st.x, st.y, st.z, st.ux, st.uy, st.uz, st.w, st.bl = (
        x, y, z, ux, uy, uz, w, bl)
    st.quota = quota
    st.alive = alive.to(torch.int32)
    return started


def record_launch_plain(st: RecordState, tab: RecordTables,
                        prm: RecordParams, seed: int, step0: int,
                        k_steps: int, acc: torch.Tensor,
                        counts: torch.Tensor) -> None:
    """``k_steps`` plain steps; adds [started, lanes with work left] into
    ``counts`` -- the contract of one kernel launch."""
    lane = torch.arange(st.x.shape[0], dtype=torch.int64, device=st.x.device)
    started = torch.zeros((), dtype=torch.int64, device=st.x.device)
    for k in range(k_steps):
        started = started + record_step_plain(st, tab, prm, lane, seed,
                                              step0 + k, acc)
    work = ((st.alive > 0) | (st.quota > 0)).sum()
    counts += torch.stack([started, work]).to(counts.dtype)


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
            [_P] * 16 + [_I] * 10 + [_U, _U] + [_I] * 4 + [_P])
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
                 seed: int, step0: int, k_steps: int, acc: torch.Tensor,
                 counts: torch.Tensor) -> None:
    global LAUNCHES
    dev = st.x.device
    n = st.x.shape[0]
    for name in RecordState.FLOAT_FIELDS:
        _check(getattr(st, name), name, torch.float32, n, dev)
    for name in RecordState.INT_FIELDS:
        _check(getattr(st, name), name, torch.int32, n, dev)
    n_cells = prm.nx * prm.ny * prm.nz
    _check(tab.records, "records", torch.float32, n_cells * prm.stride, dev)
    _check(tab.inv_a0, "inv_a0", torch.float32, tab.inv_a0.numel(), dev)
    _check(tab.inv_dd, "inv_dd", torch.float32, tab.inv_a0.numel(), dev)
    _check(prm.device_values, "params", torch.float32, N_PARAMS, dev)
    _check(acc, "acc", torch.float32, prm.n_acc, dev)
    _check(counts, "counts", torch.int32, 2, dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [prm.device_values, tab.records, tab.inv_a0, tab.inv_dd,
            *(getattr(st, k) for k in RecordState.FLOAT_FIELDS),
            st.quota, st.alive, acc, counts]
    err = lib.record_kernel_launch(
        *(t.data_ptr() for t in ptrs), n, prm.nx, prm.ny, prm.nz,
        prm.stride, prm.off_ssa, prm.off_f2, prm.inv_n_steps,
        int(prm.use_rr), prm.n_acc, seed & 0xFFFF_FFFF,
        step0 & 0xFFFF_FFFF, k_steps, int(prm.macro_factor > 0),
        int(prm.vol_tally), int(prm.analytic_hg), stream)
    LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"record_kernel launch failed: CUDA error {err}")


def record_launch(st: RecordState, tab: RecordTables, prm: RecordParams,
                  seed: int, step0: int, k_steps: int, acc: torch.Tensor,
                  counts: torch.Tensor) -> None:
    """Advance every lane by ``k_steps`` steps: the CUDA kernel for state on
    a CUDA device, the plain PyTorch step for state on the CPU."""
    if st.x.is_cuda:
        _launch_cuda(st, tab, prm, seed, step0, k_steps, acc, counts)
    elif st.x.device.type == "cpu":
        record_launch_plain(st, tab, prm, seed, step0, k_steps, acc, counts)
    else:
        raise ValueError(f"no record kernel for device {st.x.device}")


# ---------------------------------------------------------------------------
# Relaunch loop
# ---------------------------------------------------------------------------

def run_batch_record(domain: OpticalDomain, surface: Surface,
                     source: illumination.Source, seed: int,
                     rcfg: RecordConfig, photons_per_lane: int,
                     n_photons=None, use_russian_roulette: bool = True,
                     russian_roulette_weight: float = 1.0,
                     launch=record_launch):
    """Run one photon batch; returns (flux_up [nx,ny], flux_down [nx,ny],
    absorbed ([nx,ny,nz] with ``rcfg.vol_tally``, else [nx,ny]),
    n_started, n_bad, n_calls).

    Port of ``run_batch_pallas`` + ``_make_launch``: launch
    ``steps_per_call`` steps, add up the photons started and the lanes with
    work left, rebalance the unspent quota evenly over the lanes, and stop
    when no work is left or at ``max_steps``. ``seed`` is the uint32 kernel
    seed; ``launch`` is ``record_launch`` (or, to compare the two on one
    device, ``record_launch_plain``)."""
    n_lanes = rcfg.n_lanes
    if n_lanes * photons_per_lane >= 2 ** 31:
        raise ValueError(
            f"n_lanes*photons_per_lane = {n_lanes * photons_per_lane} "
            f"overflows the int32 quota budget; split into more batches")
    dev = domain.device
    prm = RecordParams.make(domain, surface, source, use_russian_roulette,
                            russian_roulette_weight, rcfg.vol_tally)
    tab = RecordTables.from_domain(domain)
    lane_i = torch.arange(n_lanes, dtype=torch.int32, device=dev)
    if n_photons is None:
        quota0 = torch.full((n_lanes,), photons_per_lane, dtype=torch.int32,
                            device=dev)
    else:
        n_ph = min(int(n_photons), n_lanes * photons_per_lane)
        quota0 = (n_ph // n_lanes + (lane_i < n_ph % n_lanes)).to(torch.int32)
    st = RecordState.initial(quota0, prm[P_BETA_MAX])
    acc = torch.zeros(prm.n_acc, dtype=torch.float32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    k = rcfg.steps_per_call
    n_started, n_calls, work = 0, 0, True
    while work and n_calls * k < rcfg.max_steps:
        counts.zero_()
        launch(st, tab, prm, seed, n_calls * k, k, acc, counts)
        started, work_left = counts.tolist()
        n_started += started
        work = work_left > 0
        # any lane may run any photon: streams are keyed by (lane, step)
        total_q = st.quota.sum()
        st.quota = (total_q // n_lanes
                    + (lane_i < total_q % n_lanes)).to(torch.int32)
        n_calls += 1
    nx, ny, nz = domain.grid.shape
    nxy = nx * ny
    flux_up = acc[:nxy].reshape(nx, ny)
    flux_down = acc[nxy:2 * nxy].reshape(nx, ny)
    absorbed = acc[2 * nxy:].reshape((nx, ny, nz) if rcfg.vol_tally
                                     else (nx, ny))
    n_bad = int(st.alive.sum())
    return flux_up, flux_down, absorbed, n_started, n_bad, n_calls


def run_batch_record_tallies(domain, surface, source, seed: int, config,
                             n_photons=None, launch=record_launch):
    """``run_batch``-compatible entry (port of ``run_batch_pallas_tallies``
    without radiance): returns a ``transport.integrator.Tallies``."""
    # absorption per column unless the 3D field or its profile is wanted
    vol = config.need_volume_absorption or config.need_absorption_profile
    rcfg, ppl = config_for(config.n_lanes, config.photons_per_lane,
                           config.max_steps, vol_tally=vol)
    if n_photons is None:
        n_photons = config.photons_per_batch
    fu, fd, ab, n_started, n_bad, n_calls = run_batch_record(
        domain, surface, source, seed, rcfg, ppl, n_photons=n_photons,
        use_russian_roulette=config.use_russian_roulette,
        russian_roulette_weight=config.russian_roulette_weight,
        launch=launch)
    return Tallies(
        flux_up=fu, flux_down=fd,
        flux_absorbed=ab.sum(dim=2) if vol else ab,
        volume_absorption=ab if vol else None,
        n_photons=n_started, n_bad=n_bad,
        n_steps=n_calls * rcfg.steps_per_call)
