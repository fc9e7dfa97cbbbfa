"""Separable-template kernel (K4): the CUDA kernel, its plain PyTorch step
and the batch entry points.

PyTorch counterpart of ``mcbrat3d_tpu.transport.pallas_sep``
(``sep_ineligibility_reasons``, ``_pack_sep_emission_groups``,
``_build_kernel_sep``, ``run_batch_pallas_sep``,
``run_batch_pallas_sep_tallies``) for flagship-scale domains whose
extinction is separable,

    beta(x, y, z) = amp[col] * p[z] + q[z],

a rank-1 scattering cloud over a horizontally uniform pure absorber, so one
value per column (at most 131,072 columns) and two per level carry a field
of millions of cells (the 325 x 325 x 150 broadband-LW flagship, reference:
run/I3RC_bench_LW.deck:45). Every lane (slot) carries one photon at a time
through ``steps_per_call`` steps per launch:

* refill from a directional, random-azimuth or flux source, or from the
  separable thermal emission: the atmosphere/surface split, a cloud or gas
  branch, the cloud column by group rejection (a Walker alias over
  128-column groups weighted by their largest amplitude, a uniform column
  in the group, accepted with amp[col] / gmax[group]), the gas column
  uniform, the level from the branch's z alias; an atmospheric refill is
  pending for one step (state 2 when rejected: it retries the same branch
  next step) and borrows the tally slot at its birth column and level for
  the LW pre-credit;
* a Woodcock jump against a three-region majorant: inside the cloud slab
  [sep_zb, sep_zt) the carried xy-block ceiling, below and above it the
  gas maxima; clipped at the xy block faces (clamped to the domain edge)
  inside the slab and at the facing slab plane, plus ``clip_nudge``; a
  photon on an outward face takes one step at the global ceiling;
* the collision with beta = amp[col] p[z] + q[z], non-analog absorption by
  the effective ssa beta_c ssa_c / beta, roulette, the cloud's single phase
  entry (analytic HG or one inverse-CDF row), rotation and Lambertian
  reflection;
* tallies of flux up, flux down and net column absorption per column and
  the net absorption z profile, LW pre-credits (-1 at the birth column and
  level) included.

Two implementations of one launch:

* ``csrc/sep_kernel.cu``, one CUDA thread per lane (``_launch_cuda``);
* ``sep_step_plain``, the same step on ``[n_lanes]`` tensors, operation for
  operation the JAX kernel's float32 arithmetic without its TPU
  workarounds: the tables are plain float32 arrays (no bf16 hi/lo splits
  of amp, p, q and the z aliases), the gathers are indexed loads (no
  one-hot products) and the tallies add exact float32 values (the JAX
  kernel rounds exit weights to bf16 and absorption to a bf16 hi/lo pair).

``run_batch_sep_tallies`` runs the refill schedule by default
(``rk.RefillSchedule``): as many slots as the card holds resident threads
for the kernel's instantiation (``occupancy``, the occupancy query;
``rk.PLAIN_SLOTS`` on the CPU), each starting its share of the batch's
photons in the kernel, in launches of ``rk.REFILL_STEPS`` steps under
``rk.relaunch_loop``; ``rk.jax_geometry`` gives the JAX package's 512 rows
of 128 lanes and 128 steps a launch.

``sep_launch`` sends CUDA tensors to the kernel and CPU tensors to the plain
step; there is no fallback between them. Both draw the counter uniforms of
``core.rng`` at K4's sites, so for one seed and lane geometry they follow
the JAX kernel's photon paths (interpret mode, whose uniforms are the
counter mixer).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

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

# Envelope shared with the JAX separable kernel (pallas_sep.MAX_COLS_SEP,
# MAX_BLOCKS and the nz <= 256 profile).
MAX_COLS = 128 * 128 * 8
MAX_BLOCKS = 128 * 128
MAX_NZ = 256
GROUP = 128  # columns per group of the emission column sampler

# Kernel launches made by ``_launch_cuda`` in this process.
SEP_LAUNCHES = 0

# Draw sites of K4 (pallas_sep.py:448-497, 574-607, 625, 724-726, 807,
# 862): refill x/y, the source's azimuth (random azimuth) or mu (flux),
# tau, collision, angle, rotation azimuth, roulette, the source azimuth
# (flux and emission), and the emission draws.
SITE_X, SITE_Y, SITE_SRC, SITE_TAU, SITE_COLLIDE = 0, 1, 2, 3, 4
SITE_ANGLE, SITE_PHI, SITE_ROULETTE, SITE_SRC_PHI = 5, 6, 7, 9
(SITE_SPLIT, SITE_BIN, SITE_ACC, SITE_MU, SITE_ZOFF, SITE_BRANCH,
 SITE_ZBIN, SITE_ZACC, SITE_LO, SITE_AMP) = range(10, 20)

# Source kinds of the kernel (csrc/sep_kernel.cu SRC_*).
SOURCE_KINDS = (illumination.DIRECTIONAL, illumination.RANDOM_AZIMUTH,
                illumination.FLUX, illumination.EMISSION)

# Slots of the float32 parameter vector (csrc/sep_kernel.cu P_*).
(P_GMAX, P_CEIL_IN, P_Q_BELOW, P_Q_ABOVE, P_ALBEDO, P_SMU, P_SUX, P_SUY,
 P_RR_W, P_HALF_RR, P_X0, P_LX, P_Y0, P_LY, P_Z0, P_SSA_C, P_G, P_ATMS,
 P_PB, P_INV_DX, P_INV_DY, P_INV_DZ, P_DZ, P_ZMAX, P_ZTOP, P_ZBOT,
 P_ZSLAB_B, P_ZSLAB_T, P_BXW, P_BYW, P_NUDGE, P_TWO_PI, P_CELL_DX,
 P_CELL_DY, P_INV_NY, N_PARAMS) = range(36)

_TINY = rk._TINY
_BIG = 3e38
_F32 = np.float32


def sep_ineligibility_reasons(domain: OpticalDomain, surface: Surface,
                              source: illumination.Source, lw_mode: bool,
                              compute_intensity: bool,
                              record_scattering_orders: int,
                              use_ray_tracing: bool,
                              need_volume_absorption: bool) -> list:
    """Names of every failing separable-kernel predicate (empty =
    eligible): port of ``pallas_sep.sep_ineligibility_reasons``, with the
    same names. An emission source, per voxel or separable-backed, is
    sampled from the domain's own separable emission tables
    (pallas_sep.py:1107-1131), so the domain must carry them."""
    nx, ny, nz = domain.grid.shape
    f = domain.macro_factor if domain.macro_factor > 0 else max(nx, ny)
    nbx, nby = -(-nx // f), -(-ny // f)
    em_ok = (source.kind != illumination.EMISSION
             or ((source.em_prob is not None or source.em_sep)
                 and domain.sep_em_zpa is not None))
    checks = (
        ("domain is not separable (beta != a[col]*p[z] + q[z]; "
         "see OpticalDomain.sep_template)", domain.sep_template),
        ("non-uniform or non-Lambertian surface",
         surface.is_uniform_lambertian),
        (f"source kind {source.kind!r} not in-kernel",
         source.kind in SOURCE_KINDS),
        ("emission source needs concrete arrays, z-uniform temps and "
         "domain lambda_um > 0 (for the separable Planck weighting)",
         em_ok),
        ("lw_mode without an emission source",
         (not lw_mode) or source.kind == illumination.EMISSION),
        ("compute_intensity (radiance) not in the separable kernel",
         not compute_intensity),
        ("record_scattering_orders > 0", record_scattering_orders == 0),
        ("use_ray_tracing=True (megakernel is max-cross-section only)",
         not use_ray_tracing),
        ("need_volume_absorption (3D tally) not in the separable kernel",
         not need_volume_absorption),
        (f"nx*ny={nx * ny} > {MAX_COLS}", nx * ny <= MAX_COLS),
        (f"xy blocks {nbx * nby} > {MAX_BLOCKS}", nbx * nby <= MAX_BLOCKS),
        (f"nz={nz} > {MAX_NZ}", nz <= MAX_NZ),
    )
    return [name for name, ok in checks if not ok]


def sep_emission_groups(amp_np: np.ndarray) -> np.ndarray:
    """[3, n_groups] float32 tables of the emission column sampler (port of
    ``pallas_sep._pack_sep_emission_groups``): per 128-column group the
    Walker acceptance, the alias target and the largest float32 amplitude
    (the acceptance compares u * gmax < amp[col] on the float32 values)."""
    nxy = amp_np.size
    n_groups = -(-nxy // GROUP)
    amp_f32 = np.asarray(amp_np, np.float32).astype(np.float64)
    gmax = np.pad(amp_f32, (0, n_groups * GROUP - nxy)).reshape(
        n_groups, GROUP).max(axis=1)
    if gmax.sum() > 0:
        prob, alias = illumination.walker_alias(gmax / gmax.sum())
    else:  # no cloud emission anywhere: never drawn (cloud branch p = 0)
        prob = np.ones(n_groups)
        alias = np.arange(n_groups, dtype=np.float64)
    return np.stack([prob, alias, gmax]).astype(np.float32)


# ---------------------------------------------------------------------------
# Kernel inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SepState:
    """Per-lane photon state ([n_lanes] each): position, direction, weight,
    the carried in-slab block ceiling ``bls``, the photons still to start
    and the lane state (0 dead, 1 alive, 2 an emission proposal that was
    claimed but not accepted, retried next step)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    w: torch.Tensor
    bls: torch.Tensor
    quota: torch.Tensor   # int32
    alive: torch.Tensor   # int32 0/1/2

    FLOAT_FIELDS = ("x", "y", "z", "ux", "uy", "uz", "w", "bls")
    INT_FIELDS = ("quota", "alive")

    @staticmethod
    def initial(quota: torch.Tensor, ceil_in_max: float) -> "SepState":
        """Fresh lanes: no photon alive, ``quota`` photons to start."""
        n = quota.shape[0]
        dev = quota.device

        def full(v):
            return torch.full((n,), v, dtype=torch.float32, device=dev)

        return SepState(x=full(0.0), y=full(0.0), z=full(0.0), ux=full(0.0),
                        uy=full(0.0), uz=full(1.0), w=full(0.0),
                        bls=full(ceil_in_max),
                        quota=quota.to(torch.int32).contiguous(),
                        alive=torch.zeros(n, dtype=torch.int32, device=dev))


@dataclasses.dataclass(frozen=True)
class SepTables:
    """Device tables the step reads: the column amplitudes padded with
    zeros to whole 128-column groups, the z profiles p and q, the xy-block
    ceilings, the emission z aliases [4 * nz] (cloud prob, cloud alias, gas
    prob, gas alias) and group tables [3 * n_groups] (prob, alias, gmax),
    and the cloud's inverse-CDF row with its forward differences;
    one-element placeholders where unused."""

    amp: torch.Tensor
    pz: torch.Tensor
    qz: torch.Tensor
    blocks: torch.Tensor
    zpa: torch.Tensor
    groups: torch.Tensor
    inv_a0: torch.Tensor
    inv_dd: torch.Tensor

    @staticmethod
    def from_domain(domain: OpticalDomain,
                    source: illumination.Source) -> "SepTables":
        dev = domain.device
        zero = torch.zeros(1, dtype=torch.float32, device=dev)
        nxy = domain.grid.nx * domain.grid.ny
        n_groups = -(-nxy // GROUP)
        amp = torch.zeros(n_groups * GROUP, dtype=torch.float32, device=dev)
        amp[:nxy] = domain.sep_amp
        if domain.sep_analytic_hg:
            a0 = dd = zero
        else:
            a0 = domain.tables.inverse[domain.sep_inv_row].contiguous()
            dd = (torch.cat([a0[1:], a0[-1:]]) - a0).contiguous()
        if source.kind == illumination.EMISSION:
            zpa = domain.sep_em_zpa.reshape(-1).contiguous()
            groups = torch.as_tensor(
                sep_emission_groups(domain.sep_amp_np).reshape(-1),
                device=dev)
        else:
            zpa = groups = zero
        return SepTables(amp=amp, pz=domain.sep_pz.contiguous(),
                         qz=domain.sep_qz.contiguous(),
                         blocks=domain.sep_block.contiguous(), zpa=zpa,
                         groups=groups, inv_a0=a0, inv_dd=dd)


@dataclasses.dataclass(frozen=True)
class SepParams:
    """Scalars of one batch: ``values`` is the float32 parameter vector
    (P_* slots, computed in float32 as the JAX kernel computes them),
    ``device_values`` its copy on the kernel's device."""

    values: np.ndarray
    device_values: torch.Tensor
    nx: int
    ny: int
    nz: int
    macro_factor: int   # the effective block width in cells (nx or ny at 0)
    nby: int
    n_blk: int
    n_groups: int
    zb: int
    zt: int
    analytic_hg: bool
    inv_n_steps: int
    use_rr: bool
    lw: bool
    source_kind: int    # index into SOURCE_KINDS

    def __getitem__(self, slot: int) -> float:
        return float(self.values[slot])

    @property
    def n_acc(self) -> int:
        """Tally entries: [up nxy | down nxy | net absorbed nxy |
        net profile nz]."""
        return 3 * self.nx * self.ny + self.nz

    @staticmethod
    def make(domain: OpticalDomain, surface: Surface,
             source: illumination.Source, use_russian_roulette: bool,
             russian_roulette_weight: float, lw_mode: bool) -> "SepParams":
        f = _F32
        nx, ny, nz = domain.grid.shape
        xe, ye, ze = domain.grid.edges_f32()
        sc = np.asarray(domain.sep_scalars, np.float32)
        gmax = max(max(sc[2], sc[3]), max(sc[4], f(_TINY)))
        if source.kind in (illumination.DIRECTIONAL,
                           illumination.RANDOM_AZIMUTH):
            smu = f(source.solar_mu)
            sphi = (f(source.solar_azimuth)
                    if source.kind == illumination.DIRECTIONAL else f(0.0))
        else:
            smu, sphi = f(0.0), f(0.0)
        sth = np.sqrt(max(f(0.0), f(1.0) - smu * smu))
        emission = source.kind == illumination.EMISSION
        lx, ly, lz = xe[-1] - xe[0], ye[-1] - ye[0], ze[-1] - ze[0]
        mf = (domain.macro_factor if domain.macro_factor > 0
              else max(nx, ny))
        dz = lz / f(nz)
        bxw, byw = lx / f(nx) * f(mf), ly / f(ny) * f(mf)
        rr_w = f(russian_roulette_weight)
        vals = np.zeros(N_PARAMS, np.float32)
        vals[[P_GMAX, P_CEIL_IN, P_Q_BELOW, P_Q_ABOVE]] = (gmax, sc[4],
                                                           sc[2], sc[3])
        vals[[P_ALBEDO, P_SMU, P_SUX, P_SUY, P_RR_W, P_HALF_RR]] = (
            f(surface.albedo), smu, sth * np.cos(sphi), sth * np.sin(sphi),
            rr_w, f(0.5) * rr_w)
        vals[[P_X0, P_LX, P_Y0, P_LY, P_Z0]] = (xe[0], lx, ye[0], ly, ze[0])
        vals[[P_SSA_C, P_G]] = sc[0], sc[1]
        if emission:
            vals[P_ATMS] = source.atms_fraction
            vals[P_PB] = domain.sep_em_pb[0]
        vals[[P_INV_DX, P_INV_DY, P_INV_DZ, P_DZ]] = (
            f(nx) / lx, f(ny) / ly, f(nz) / lz, dz)
        z_max, z_eps = ze[0] + lz, lz * f(1e-6)
        vals[[P_ZMAX, P_ZTOP, P_ZBOT]] = z_max, z_max - z_eps, ze[0] + z_eps
        vals[[P_ZSLAB_B, P_ZSLAB_T]] = (ze[0] + f(domain.sep_zb) * dz,
                                        ze[0] + f(domain.sep_zt) * dz)
        vals[[P_BXW, P_BYW, P_NUDGE, P_TWO_PI]] = (
            bxw, byw, f(1e-5) * min(min(bxw, byw), dz), f(2.0 * np.pi))
        vals[[P_CELL_DX, P_CELL_DY, P_INV_NY]] = (lx / f(nx), ly / f(ny),
                                                  f(1.0 / ny))
        nbx, nby = -(-nx // mf), -(-ny // mf)
        return SepParams(
            values=vals,
            device_values=torch.as_tensor(vals, device=domain.device),
            nx=nx, ny=ny, nz=nz, macro_factor=int(mf), nby=nby,
            n_blk=nbx * nby, n_groups=-(-(nx * ny) // GROUP),
            zb=int(domain.sep_zb), zt=int(domain.sep_zt),
            analytic_hg=bool(domain.sep_analytic_hg),
            inv_n_steps=int(domain.tables.inverse.shape[1]),
            use_rr=bool(use_russian_roulette),
            lw=bool(lw_mode) and emission,
            source_kind=SOURCE_KINDS.index(source.kind))


@dataclasses.dataclass(frozen=True)
class SepTally:
    """What a launch adds into: ``acc`` the tallies [prm.n_acc] f32 and
    ``counts`` int64 [photons started, lanes with work left, lane-steps run
    with a live photon] (``rk.relaunch_loop`` layout)."""

    acc: torch.Tensor
    counts: torch.Tensor

    @staticmethod
    def zeros(prm: SepParams, device) -> "SepTally":
        return SepTally(
            acc=torch.zeros(prm.n_acc, dtype=torch.float32, device=device),
            counts=torch.zeros(3, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# Plain PyTorch step
# ---------------------------------------------------------------------------

def _emission_refill(u, ctr, tab: SepTables, p: SepParams, need, committed):
    """The separable BBEmission proposal of every lane (pallas_sep.py:
    453-586): (position, direction cosine, pending, column, level, cloud
    branch, group maximum)."""
    nx, ny, nz = p.nx, p.ny, p.nz
    nxy, n_groups = nx * ny, p.n_groups
    u0, u1 = u(ctr, SITE_X), u(ctr, SITE_Y)
    u_bin, u_mu = u(ctr, SITE_BIN), u(ctr, SITE_MU)
    # committed lanes retry the same (atmospheric, cloud) branch
    from_atm = (u(ctr, SITE_SPLIT) < p[P_ATMS]) | committed
    cloud_br = (u(ctr, SITE_BRANCH) < p[P_PB]) | committed

    # cloud column: a group by Walker alias over the group maxima, a
    # uniform column in it (accepted against amp next to the gather)
    g = tab.groups
    jg = (u_bin * float(n_groups)).to(torch.int32).clamp(max=n_groups - 1)
    jg = jg.long()
    g_i = torch.where(u(ctr, SITE_ACC) < g[jg], jg,
                      (g[n_groups + jg] + 0.5).to(torch.int64))
    accept_gmax = g[2 * n_groups + g_i]
    lo = (u(ctr, SITE_LO) * 128.0).to(torch.int32).clamp(max=GROUP - 1)
    col_cloud = g_i * GROUP + lo.long()
    # gas column: uniform, from the alias-bin draw
    col_gas = (u_bin * float(nxy)).to(torch.int32).clamp(max=nxy - 1).long()
    col_b = torch.where(cloud_br, col_cloud, col_gas)

    # level: the branch's z alias
    zbin = (u(ctr, SITE_ZBIN) * float(nz)).to(torch.int32).clamp(max=nz - 1)
    zbin = zbin.long()
    u_zacc = u(ctr, SITE_ZACC)
    zpa = tab.zpa
    z_c = torch.where(u_zacc < zpa[zbin], zbin,
                      (zpa[nz + zbin] + 0.5).to(torch.int64))
    z_g = torch.where(u_zacc < zpa[2 * nz + zbin], zbin,
                      (zpa[3 * nz + zbin] + 0.5).to(torch.int64))
    iz_b = torch.where(cloud_br, z_c, z_g)

    colf = col_b.to(torch.float32)
    ixf = torch.floor((colf + 0.5) * p[P_INV_NY])
    iyf = colf - ixf * float(ny)
    x0, y0, z0 = p[P_X0], p[P_Y0], p[P_Z0]
    xa = x0 + (ixf + u0) * p[P_CELL_DX]
    ya = y0 + (iyf + u1) * p[P_CELL_DY]
    za = torch.clamp(z0 + (iz_b.to(torch.float32) + u(ctr, SITE_ZOFF))
                     * p[P_DZ], p[P_ZBOT], p[P_ZTOP])
    mu_a = 1.0 - 2.0 * u_mu
    mu_a = torch.where(mu_a.abs() < 1e-4, torch.sign(mu_a + _TINY) * 1e-4,
                       mu_a)
    mu_sfc = torch.sqrt(torch.clamp(u_mu, min=1e-12))
    s_mu = torch.where(from_atm, mu_a, mu_sfc)
    xs = torch.where(from_atm, xa, x0 + u0 * p[P_LX])
    ys = torch.where(from_atm, ya, y0 + u1 * p[P_LY])
    zs = torch.where(from_atm, za, torch.full_like(za, p[P_ZBOT]))
    return (xs, ys, zs, s_mu, need & from_atm, col_b, iz_b, cloud_br,
            accept_gmax)


def sep_step_plain(st: SepState, tab: SepTables, prm: SepParams,
                   lane: torch.Tensor, seed: int, ctr: int,
                   tally: SepTally) -> torch.Tensor:
    """One transport step for every lane; returns the photons started.

    ``lane`` holds the int64 lane indices, ``ctr`` the step counter;
    ``tally`` receives this step's tallies. Operation for operation the
    JAX kernel's float32 arithmetic (pallas_sep.py _build_kernel_sep)."""
    p = prm
    u = rng.make_uniform(lane, seed)
    x0, lx, y0, ly = p[P_X0], p[P_LX], p[P_Y0], p[P_LY]
    z0, z_max = p[P_Z0], p[P_ZMAX]
    gmax, ceil_in = p[P_GMAX], p[P_CEIL_IN]
    nx, ny, nz = p.nx, p.ny, p.nz
    nxy = nx * ny
    two_pi = p[P_TWO_PI]
    x, y, z, ux, uy, uz, w = st.x, st.y, st.z, st.ux, st.uy, st.uz, st.w
    bls, quota = st.bls, st.quota

    # ---- refill dead lanes from the source ----
    alive = st.alive == 1
    committed = st.alive == 2
    dead_new = (st.alive == 0) & (quota > 0)
    need = dead_new | committed
    kind = SOURCE_KINDS[p.source_kind]
    pending = None
    if kind == illumination.EMISSION:
        (xs, ys, zs, s_mu, pending, col_b, iz_b, cloud_br,
         accept_gmax) = _emission_refill(u, ctr, tab, p, need, committed)
        s_phi = two_pi * u(ctr, SITE_SRC_PHI)
    else:
        xs = x0 + u(ctr, SITE_X) * lx
        ys = y0 + u(ctr, SITE_Y) * ly
        zs = torch.full_like(x, p[P_ZTOP])
        if kind == illumination.DIRECTIONAL:
            s_mu = torch.full_like(x, -p[P_SMU])
        elif kind == illumination.RANDOM_AZIMUTH:
            s_mu = torch.full_like(x, -p[P_SMU])
            s_phi = two_pi * u(ctr, SITE_SRC)
        else:  # flux: mu = -sqrt(u), azimuth at its own site
            s_mu = -torch.sqrt(torch.clamp(u(ctr, SITE_SRC), min=1e-12))
            s_phi = two_pi * u(ctr, SITE_SRC_PHI)
    if kind == illumination.DIRECTIONAL:
        sux = torch.full_like(x, p[P_SUX])
        suy = torch.full_like(x, p[P_SUY])
    else:
        s_sin = torch.sqrt(torch.clamp(1.0 - s_mu * s_mu, min=0.0))
        sux = s_sin * torch.cos(s_phi)
        suy = s_sin * torch.sin(s_phi)
    x = torch.where(need, xs, x)
    y = torch.where(need, ys, y)
    z = torch.where(need, zs, z)
    ux = torch.where(need, sux, ux)
    uy = torch.where(need, suy, uy)
    uz = torch.where(need, s_mu, uz)
    w = torch.where(need, 1.0, w)
    go_now = need if pending is None else need & ~pending
    alive = alive | go_now
    # a pending lane claims its quota unit at its first proposal;
    # ``started`` counts activations only (go_now here, accept below)
    claim = go_now if pending is None else go_now | (pending & dead_new)
    quota = quota - claim.to(torch.int32)
    started = go_now.sum()
    tally.counts[2] += alive.sum()
    bls = torch.where(need, ceil_in, bls)

    # ---- Woodcock jump with the three-region ceiling ----
    tau = -torch.log1p(-u(ctr, SITE_TAU))
    zs_b, zs_t = p[P_ZSLAB_B], p[P_ZSLAB_T]
    in_slab = (z >= zs_b) & (z < zs_t)
    below = z < zs_b
    ceiling = torch.where(in_slab, bls,
                          torch.where(below, p[P_Q_BELOW], p[P_Q_ABOVE]))
    d_samp = torch.where(ceiling > 0,
                         tau / torch.where(ceiling == 0, 1.0, ceiling), _BIG)
    # clip planes: the facing slab plane always, the xy block faces (clamped
    # to the domain edge) inside the slab only
    tx = torch.where(in_slab, rk.face_distance(x, x0, ux, p[P_BXW], lx),
                     _BIG)
    ty = torch.where(in_slab, rk.face_distance(y, y0, uy, p[P_BYW], ly),
                     _BIG)
    z_plane = torch.where(in_slab,
                          torch.where(uz >= 0, zs_t, zs_b),
                          torch.where(below, zs_b, zs_t))
    plane_ok = torch.where(in_slab, uz.abs(),
                           torch.where(below, uz, -uz)) > 1e-12
    tz_p = torch.where(plane_ok,
                       (z_plane - z) / torch.where(uz == 0, 1.0, uz), _BIG)
    t_raw = torch.minimum(torch.minimum(tx, ty), tz_p)
    # a photon exactly on an outward face takes one global-ceiling step
    escape = t_raw <= 0.0
    bls = torch.where(escape, ceil_in, bls)
    ceiling = torch.where(escape, gmax, ceiling)
    d_samp = torch.where(escape, rk.div_scalar(tau, gmax), d_samp)
    t_clip = torch.where(escape, _BIG, t_raw + p[P_NUDGE])
    clipped = t_clip < d_samp
    d = torch.minimum(d_samp, t_clip)

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
    ixe = ((xe - x0) * p[P_INV_DX]).to(torch.int32).clamp(0, nx - 1)
    iye = ((ye - y0) * p[P_INV_DY]).to(torch.int32).clamp(0, ny - 1)
    col_e = ixe * ny + iye

    # collision column / level
    xc = x0 + torch.remainder((x + ux * d) - x0, lx)
    yc = y0 + torch.remainder((y + uy * d) - y0, ly)
    zc = torch.clamp(zn, z0, z_max)
    ix = ((xc - x0) * p[P_INV_DX]).to(torch.int32).clamp(0, nx - 1)
    iy = ((yc - y0) * p[P_INV_DY]).to(torch.int32).clamp(0, ny - 1)
    iz = ((zc - z0) * p[P_INV_DZ]).to(torch.int32).clamp(0, nz - 1).long()
    exits = exit_top | exit_bot
    col_t = torch.where(exits, col_e, ix * ny + iy).long()
    if pending is not None:
        # pending refills borrow the gather and tally slots (they neither
        # move nor collide this step)
        col_t = torch.where(pending, col_b, col_t)
        iz = torch.where(pending, iz_b, iz)

    u_ang = u(ctr, SITE_ANGLE)
    phi_rot = two_pi * u(ctr, SITE_PHI)

    # ---- amplitude gather; group-rejection acceptance of the proposals
    # (the gas branch always, the cloud branch with amp / gmax) ----
    amp = tab.amp[col_t]
    if pending is not None:
        accept = pending & (~cloud_br
                            | (u(ctr, SITE_AMP) * accept_gmax < amp))
        alive = alive | accept
        started = started + accept.sum()

    beta_c = amp * tab.pz[iz]
    beta = beta_c + tab.qz[iz]

    # ---- block ceiling at the destination ----
    mf = p.macro_factor
    bidx = ((ix // mf) * p.nby + iy // mf).long()
    bls = torch.where(moved, tab.blocks[bidx], bls)

    # null-collision test against the ceiling this jump sampled with
    real = collide & (u(ctr, SITE_COLLIDE) * ceiling < beta)
    # non-analog absorption by the effective ssa: the gas only absorbs
    ssa_eff = torch.where(beta > 0, beta_c * p[P_SSA_C]
                          / torch.where(beta == 0, 1.0, beta), 0.0)
    absorbed = torch.where(real, w * (1.0 - ssa_eff), 0.0)
    if p.lw:
        # LW emission pre-credit: -1 at the birth column / level, through
        # the pending lane's slot (reference:
        # Integrators/monteCarloRadiativeTransfer.f95:504-508)
        absorbed = absorbed - accept.to(torch.float32)
    w = torch.where(real, w * ssa_eff, w)

    # ---- Russian roulette ----
    if p.use_rr:
        rr_w = p[P_RR_W]
        play = real & (w < p[P_HALF_RR])
        survive = u(ctr, SITE_ROULETTE) < rk.div_scalar(w, rr_w)
        w = torch.where(play, torch.where(survive, rr_w, 0.0), w)
    died_weight = real & (w <= _TINY)

    # ---- scattering: the cloud's single phase entry ----
    scatter = real & ~died_weight
    if p.analytic_hg:
        cos_t = sample_hg_cos(torch.full_like(u_ang, p[P_G]), u_ang)
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
    w_refl = w_down * p[P_ALBEDO]
    died_surface = exit_bot & (w_refl <= _TINY)
    reflected = exit_bot & ~died_surface
    mu_new = torch.sqrt(torch.clamp(u_ang, min=1e-12))
    sin_new = torch.sqrt(torch.clamp(1.0 - mu_new * mu_new, min=0.0))
    x = torch.where(exit_bot, xe, torch.where(moved, xc, x))
    y = torch.where(exit_bot, ye, torch.where(moved, yc, y))
    z = torch.where(exit_bot, p[P_ZBOT], torch.where(moved, zc, z))
    ux = torch.where(reflected, sin_new * torch.cos(phi_rot), ux)
    uy = torch.where(reflected, sin_new * torch.sin(phi_rot), uy)
    uz = torch.where(reflected, mu_new, uz)
    w = torch.where(reflected, w_refl, w)
    bls = torch.where(exit_bot, ceil_in, bls)
    alive = alive & ~exit_top & ~died_weight & ~died_surface

    # ---- tallies: exits at the crossing column, net absorption at the
    # collision (or birth) column and level ----
    v_up = torch.where(exit_top, w, 0.0)
    v_dn = torch.where(exit_bot, w_down, 0.0)
    # a rejected proposal's column may lie in the zero padding past nxy;
    # its tallies are 0
    col_s = torch.where(col_t < nxy, col_t, 0)
    acc = tally.acc
    acc.index_add_(0, col_s, v_up)
    acc.index_add_(0, nxy + col_s, v_dn)
    acc.index_add_(0, 2 * nxy + col_s, absorbed)
    acc[3 * nxy:] += rk.level_sums(iz, absorbed, prm.nz)

    st.x, st.y, st.z, st.ux, st.uy, st.uz, st.w = x, y, z, ux, uy, uz, w
    st.bls, st.quota = bls, quota
    alive_i = alive.to(torch.int32)
    if pending is not None:
        # rejected proposals carry state 2
        alive_i = torch.where(pending & ~accept, 2, alive_i)
    st.alive = alive_i
    return started


def sep_launch_plain(st: SepState, tab: SepTables, prm: SepParams,
                     seed: int, step0: int, k_steps: int,
                     tally: SepTally) -> None:
    """``k_steps`` plain steps; adds [started, lanes with work left,
    lane-steps] into ``tally.counts`` -- the contract of one kernel
    launch. Once no lane has a photon, a claim or quota the remaining steps
    would change nothing, and are not run (as the kernel's lanes stop)."""
    lane = torch.arange(st.x.shape[0], dtype=torch.int64, device=st.x.device)
    started = torch.zeros((), dtype=torch.int64, device=st.x.device)
    for k in range(k_steps):
        if not ((st.alive > 0) | (st.quota > 0)).any():
            break
        started = started + sep_step_plain(st, tab, prm, lane, seed,
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
    lib = _build.load("sep_kernel")
    if not getattr(lib, "_mcb_typed", False):
        lib.sep_kernel_num_params.restype = _I
        lib.sep_kernel_num_params.argtypes = []
        lib.sep_kernel_launch.restype = _I
        lib.sep_kernel_launch.argtypes = (
            [_P] * 21 + [_I] * 12 + [_U, _U] + [_I] * 5 + [_P])
        lib.sep_kernel_occupancy.restype = _I
        lib.sep_kernel_occupancy.argtypes = [_I] * 8 + [_P]
        if lib.sep_kernel_num_params() != N_PARAMS:
            raise RuntimeError("csrc/sep_kernel.cu and sep_kernel.py "
                               "disagree on the parameter layout")
        lib._mcb_typed = True
    return lib


def _launch_cuda(st: SepState, tab: SepTables, prm: SepParams, seed: int,
                 step0: int, k_steps: int, tally: SepTally) -> None:
    global SEP_LAUNCHES
    dev = st.x.device
    n = st.x.shape[0]
    check = rk._check
    for name in SepState.FLOAT_FIELDS:
        check(getattr(st, name), name, torch.float32, n, dev)
    for name in SepState.INT_FIELDS:
        check(getattr(st, name), name, torch.int32, n, dev)
    emission = SOURCE_KINDS[prm.source_kind] == illumination.EMISSION
    check(tab.amp, "amp", torch.float32, prm.n_groups * GROUP, dev)
    check(tab.pz, "pz", torch.float32, prm.nz, dev)
    check(tab.qz, "qz", torch.float32, prm.nz, dev)
    check(tab.blocks, "blocks", torch.float32, prm.n_blk, dev)
    check(tab.zpa, "zpa", torch.float32, 4 * prm.nz if emission else 1, dev)
    check(tab.groups, "groups", torch.float32,
          3 * prm.n_groups if emission else 1, dev)
    inv_n = tab.inv_a0.numel()
    if not prm.analytic_hg and inv_n != prm.inv_n_steps:
        raise ValueError(f"inverse-CDF row has {inv_n} entries, expected "
                         f"{prm.inv_n_steps}")
    check(tab.inv_a0, "inv_a0", torch.float32, inv_n, dev)
    check(tab.inv_dd, "inv_dd", torch.float32, inv_n, dev)
    check(prm.device_values, "params", torch.float32, N_PARAMS, dev)
    check(tally.acc, "acc", torch.float32, prm.n_acc, dev)
    check(tally.counts, "counts", torch.int64, 3, dev)
    if prm.nz > MAX_NZ or prm.nx * prm.ny > MAX_COLS:
        raise ValueError(f"{prm.nx}x{prm.ny}x{prm.nz} is past the kernel's "
                         f"envelope ({MAX_COLS} columns, nz <= {MAX_NZ})")
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [prm.device_values, tab.amp, tab.pz, tab.qz, tab.blocks, tab.zpa,
            tab.groups, tab.inv_a0, tab.inv_dd,
            *(getattr(st, k) for k in SepState.FLOAT_FIELDS),
            st.quota, st.alive, tally.acc, tally.counts]
    err = lib.sep_kernel_launch(
        *(t.data_ptr() for t in ptrs), n, prm.nx, prm.ny, prm.nz,
        prm.macro_factor, prm.nby, prm.n_blk, prm.n_groups, prm.zb, prm.zt,
        prm.inv_n_steps, prm.n_acc, seed & 0xFFFF_FFFF, step0 & 0xFFFF_FFFF,
        k_steps, int(prm.analytic_hg), int(prm.use_rr), int(prm.lw),
        prm.source_kind, stream)
    SEP_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"sep_kernel launch failed: CUDA error {err}")


def occupancy(prm: SepParams) -> dict:
    """The kernel's occupancy record for ``prm``'s instantiation and the
    shared-memory layout ``sep_launch`` takes for it, on the current card
    (``rk.OCCUPANCY_KEYS``)."""
    out = (ctypes.c_int * len(rk.OCCUPANCY_KEYS))()
    err = _library().sep_kernel_occupancy(
        prm.nz, prm.n_groups, prm.n_blk, prm.inv_n_steps,
        int(prm.analytic_hg), int(prm.use_rr), int(prm.lw),
        prm.source_kind, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"sep_kernel occupancy query failed: CUDA error "
                           f"{err}")
    return dict(zip(rk.OCCUPANCY_KEYS, out))


def sep_launch(st: SepState, tab: SepTables, prm: SepParams, seed: int,
               step0: int, k_steps: int, tally: SepTally) -> None:
    """Advance every lane by ``k_steps`` steps: the CUDA kernel for state on
    a CUDA device, the plain PyTorch step for state on the CPU."""
    if st.x.is_cuda:
        _launch_cuda(st, tab, prm, seed, step0, k_steps, tally)
    elif st.x.device.type == "cpu":
        sep_launch_plain(st, tab, prm, seed, step0, k_steps, tally)
    else:
        raise ValueError(f"no separable kernel for device {st.x.device}")


# ---------------------------------------------------------------------------
# Batch entry points
# ---------------------------------------------------------------------------

def run_batch_sep(domain: OpticalDomain, surface: Surface,
                  source: illumination.Source, seed: int,
                  scfg, photons_per_lane: Optional[int] = None,
                  n_photons=None, use_russian_roulette: bool = True,
                  russian_roulette_weight: float = 1.0,
                  lw_mode: bool = False, launch=sep_launch) -> Tallies:
    """One photon batch through the separable kernel (port of
    ``run_batch_pallas_sep``): the unnormalized tallies, with the net
    column absorption (LW pre-credits included) in ``flux_absorbed`` and
    its z marginal in ``absorption_profile``.

    ``scfg`` is a ``rk.RecordConfig``, the launch geometry (rows of 128
    lanes, ``photons_per_lane`` photons each at most, steps per launch, the
    step cap), or a ``rk.RefillSchedule``: the card's resident slots for
    this kernel instantiation (``occupancy``, or the schedule's own
    count), at most the batch's ``n_photons`` (required then), each
    starting its share of them in the kernel, in launches of ``k_steps``
    (``rk.resolve_schedule``).
    ``seed`` is the uint32 kernel seed; ``launch`` is ``sep_launch`` (or,
    to compare the two on one device, ``sep_launch_plain``). ``n_bad``
    counts lanes still holding a photon or a claimed emission proposal at
    the step cap; ``n_steps`` is launches x steps a launch."""
    reasons = sep_ineligibility_reasons(
        domain, surface, source, lw_mode, compute_intensity=False,
        record_scattering_orders=0, use_ray_tracing=False,
        need_volume_absorption=False)
    if reasons:
        raise NotImplementedError(
            "configuration outside the separable kernel; failing "
            "predicates: " + "; ".join(reasons))
    dev = domain.device
    prm = SepParams.make(domain, surface, source, use_russian_roulette,
                         russian_roulette_weight, lw_mode)
    tab = SepTables.from_domain(domain, source)
    scfg, photons_per_lane = rk.resolve_schedule(
        scfg, n_photons, photons_per_lane, lambda: occupancy(prm), dev)
    quota0 = rk.initial_quota(scfg.n_lanes, photons_per_lane, n_photons, dev)
    st = SepState.initial(quota0, prm[P_CEIL_IN])
    tally = SepTally.zeros(prm, dev)
    k = scfg.steps_per_call
    n_started, n_calls, lane_steps, _ = rk.relaunch_loop(
        st, tally.counts,
        lambda step0: launch(st, tab, prm, seed, step0, k, tally),
        k, scfg.max_steps)
    nx, ny, nz = domain.grid.shape
    nxy = nx * ny
    acc = tally.acc
    return Tallies(
        flux_up=acc[:nxy].reshape(nx, ny),
        flux_down=acc[nxy:2 * nxy].reshape(nx, ny),
        flux_absorbed=acc[2 * nxy:3 * nxy].reshape(nx, ny),
        volume_absorption=None,
        absorption_profile=acc[3 * nxy:],
        n_photons=n_started, n_bad=int((st.alive > 0).sum()),
        n_steps=n_calls * k, n_lane_steps=lane_steps)


def run_batch_sep_tallies(domain, surface, source, seed: int, config,
                          n_photons=None, launch=sep_launch,
                          scfg=None) -> Tallies:
    """``run_batch``-compatible entry (port of
    ``run_batch_pallas_sep_tallies``): the refill schedule by default
    (``rk.RefillSchedule``: the card's resident slots, launches of
    ``rk.REFILL_STEPS`` steps, ``config.max_steps`` rounded up to whole
    launches), or the launch geometry ``scfg`` (``rk.jax_geometry(config)``
    is the JAX package's: at most 512 rows of 128 lanes, 128 steps a
    launch, so that its lanes carry the JAX kernel's photons)."""
    if scfg is None:
        scfg = rk.RefillSchedule(config.max_steps)
    if n_photons is None:
        n_photons = config.photons_per_batch
    return run_batch_sep(
        domain, surface, source, seed, scfg, n_photons=n_photons,
        use_russian_roulette=config.use_russian_roulette,
        russian_roulette_weight=config.russian_roulette_weight,
        lw_mode=config.lw_mode, launch=launch)
