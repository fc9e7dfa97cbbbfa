"""Factorized per-bin domain rebuilds for broadband loops (PyTorch port).

Counterpart of ``mcbrat3d_tpu.domain.sep_plan`` (host-side NumPy). The
reference rebuilds the full per-cell optical domain for every wavelength
bin (read_SSPTable per bin; reference: Drivers/monteCarloDriver.f95:
889-1129, src/opticalProperties.f95:181-345). Every input to that sweep
except the per-lambda SSP table columns is lambda-independent. When

  * there is exactly one particle component and at most one pure-absorbing
    gas component (the separable kernel's class),
  * massConc is exactly rank-1 (amp[x,y] * mprof[z]),
  * Reff has a single table-interpolation cell (il, f) over active cells,
  * numConc and temps are horizontally uniform,

every bin's domain is separable with the same column amplitude, and the
per-bin rebuild collapses to O(nz) work:

  beta_cloud(x,y,z; lam) = amp[x,y] * (mprof[z] * k_lam),
      k_lam = (1-f)*extT[il,lam] + f*extT[il+1,lam]
  q(z; lam) = xsec[z,lam] * numProf[z] * 1000
  ssa_lam, phase entry: scalars (same interpolation weights every bin).

``make_separable_bin_plan`` checks the lambda-independent structure once;
``build_domain_from_plan`` then assembles each bin's compact domain from 1D
profiles and per-lambda scalars -- the domain
``build_domain(device_fields='compact')`` would produce, without touching
any 3D array. The JAX plan also hoists the per-column emission alias; the
port's kernel draws the emitting column by group rejection over the
amplitudes instead, so the plan has no such table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.domain.common import CommonDomain
from mcbrat3d_tpu_torch.domain.domain import (OpticalDomain,
                                              domain_from_numpy, sep_blockmax,
                                              sep_fields, stack_phase_tables)
from mcbrat3d_tpu_torch.domain.ssp import (SSPComponent, SSPTable,
                                           particle_phase_table)
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunction,
                                                       PhaseFunctionTable)


@dataclasses.dataclass(frozen=True)
class SeparableBinPlan:
    """Lambda-independent factorization of (CommonDomain, SSP tables)."""

    # cloud factorization: mass = amp2d x mprof (exact within tol)
    amp: np.ndarray            # [nx*ny] f32, C-order flattened amp2d
    amp_sum: float
    amp_max: float
    amp_blockmax: np.ndarray   # [nbx, nby] f32 (at the plan's macro_factor)
    macro_factor: int
    mprof: np.ndarray          # [nz] f64 (mass z-profile, full nz)
    zb: int                    # cloud slab bounds: mprof > 0 on [zb, zt)
    zt: int
    # Reff interpolation (single cell over active cells)
    il0: int
    f0: float
    entry: int                 # nearest phase entry (f0 < 0.5 ? il0 : il0+1)
    cloud: SSPComponent
    cloud_offset: int          # phase-table rows before the cloud component
    comp_kinds: tuple          # ('gas'|'cloud', ...) in flattened order
    # gas profile (pure absorber), or None
    gas: Optional[SSPComponent]
    num_prof: Optional[np.ndarray]  # [nz_gas] f64
    # horizontally uniform temperatures (None when temps vary or absent)
    tz: Optional[np.ndarray]   # [nz] f64
    dz_km: float


def _rank1_factor(field, tol_rel=4e-6):
    """Exact-within-tol rank-1 factorization field = amp[x,y] * prof[z],
    in float64 (the strongest column as the profile, the amplitude from the
    profile's peak level; the tolerance of the separable detection).
    Returns (amp2d, prof, zb, zt) or None."""
    nx, ny, nz = field.shape
    occ = field > 0
    if not occ.any():
        return None
    ij = np.unravel_index(np.argmax(field.sum(axis=2)), (nx, ny))
    prof = field[ij[0], ij[1], :].astype(np.float64)
    zref = int(np.argmax(prof))
    if prof[zref] <= 0:
        return None
    amp = (field[:, :, zref] / prof[zref]).astype(np.float64)
    if bool(np.any(occ.any(axis=2) & (amp <= 0))):
        return None
    approx = amp[:, :, None] * prof[None, None, :]
    tol = tol_rel * float(field.max())
    if not bool(np.all(np.abs(field - approx) <= tol + tol_rel * approx)):
        return None
    nzp = np.nonzero(prof > 0)[0]
    return amp, prof, int(nzp[0]), int(nzp[-1]) + 1


def make_separable_bin_plan(common: CommonDomain,
                            ssp_tables: Sequence[SSPTable],
                            calc_rayleigh: bool,
                            macro_factor: int) -> Optional[SeparableBinPlan]:
    """Factor the lambda-independent structure once, or return None.

    All full-3D-field checks happen here (once per run); a plan guarantees
    that every bin's ``build_domain_from_plan`` gives the domain of the
    generic compact rebuild."""
    grid = common.grid
    nx, ny, nz = grid.shape
    if (calc_rayleigh or nz > 256 or nx * ny > 131072
            or not (grid.xy_regular and grid.z_regular)):
        return None

    # structure: exactly one particle volExt + at most one absXsec gas
    comps = [(ti, c) for ti, tbl in enumerate(ssp_tables)
             for c in tbl.components]
    kinds = tuple("gas" if c.ext_type == "absXsec" else "cloud"
                  for _, c in comps)
    if kinds.count("cloud") != 1 or len(comps) > 2:
        return None
    ci = kinds.index("cloud")
    cloud = comps[ci][1]
    gas = comps[1 - ci][1] if len(comps) == 2 else None
    if (common.mass_conc is None or common.mass_conc.shape[0] != 1
            or common.reff is None):
        return None
    if cloud.z_level_base != 0 or cloud.extinction is None:
        return None

    # cloud: rank-1 mass + single Reff interpolation cell over active cells
    mass = np.asarray(common.mass_conc[0], np.float64)
    if mass.shape[2] != nz:
        return None
    fac = _rank1_factor(mass)
    if fac is None:
        return None
    amp2d, mprof, zb, zt = fac
    reff = np.asarray(common.reff[0], np.float64)
    key = np.asarray(cloud.key, np.float64)
    active = mass > 0.0
    if np.any(active & ((reff < key.min()) | (reff >= key.max()))):
        return None  # components_from_ssp would raise; let it
    il = np.clip(np.searchsorted(key, reff) - 1, 0, key.size - 2)
    f = (reff - key[il]) / (key[il + 1] - key[il])
    il_a, f_a = il[active], f[active]
    if il_a.size == 0 or not (np.all(il_a == il_a.flat[0])
                              and np.all(f_a == f_a.flat[0])):
        return None
    il0, f0 = int(il_a.flat[0]), float(f_a.flat[0])

    # gas: horizontally uniform number concentration
    num_prof = None
    if gas is not None:
        if common.num_conc is None or gas.xsec is None:
            return None
        nzc = gas.xsec.shape[0]
        zgb = gas.z_level_base
        num = np.asarray(common.num_conc[:, :, zgb:zgb + nzc], np.float64)
        if not np.all(num == num[0:1, 0:1, :]):
            return None
        num_prof = num[0, 0, :]

    # temperatures: horizontally uniform (required for the emission
    # tables; SW plans carry tz=None and skip them)
    tz = None
    if common.temps is not None:
        t = np.asarray(common.temps, np.float64)
        if bool(np.all(t == t[0:1, 0:1, :])):
            tz = t[0, 0, :].copy()

    amp32 = amp2d.astype(np.float32)
    ze = grid.edges_np()[2]
    return SeparableBinPlan(
        amp=amp32.reshape(-1),
        amp_sum=float(amp32.reshape(-1).astype(np.float64).sum()),
        amp_max=float(amp32.max()),
        amp_blockmax=sep_blockmax(amp32, nx, ny, macro_factor),
        macro_factor=int(macro_factor),
        mprof=mprof, zb=zb, zt=zt,
        il0=il0, f0=f0, entry=(il0 if f0 < 0.5 else il0 + 1),
        cloud=cloud,
        cloud_offset=(1 if (gas is not None and ci == 1) else 0),
        comp_kinds=kinds,
        gas=gas, num_prof=num_prof,
        tz=tz,
        dz_km=float(ze[-1] - ze[0]) / nz)


def plan_bin_scalars(plan: SeparableBinPlan, li: int):
    """(k_lam, ssa_lam): the cloud's per-lambda mass-extinction scale and
    single-scattering albedo at the plan's Reff interpolation cell."""
    ext_t = plan.cloud.extinction[:, li]
    ssa_t = plan.cloud.ssa[:, li]
    k = (1.0 - plan.f0) * ext_t[plan.il0] + plan.f0 * ext_t[plan.il0 + 1]
    s = (1.0 - plan.f0) * ssa_t[plan.il0] + plan.f0 * ssa_t[plan.il0 + 1]
    return float(k), float(s)


def plan_gas_profile(plan: SeparableBinPlan, li: int, nz: int) -> np.ndarray:
    """q[z]: the gas absorber's extinction profile [km^-1] at bin li."""
    q = np.zeros(nz, np.float64)
    if plan.gas is not None:
        zgb = plan.gas.z_level_base
        nzc = plan.gas.xsec.shape[0]
        q[zgb:zgb + nzc] = plan.gas.xsec[:, li] * plan.num_prof * 1000.0
    return q


def build_domain_from_plan(grid: Grid, plan: SeparableBinPlan, li: int,
                           lambda_um: float,
                           n_cdf_steps: int = 9001,
                           n_forward_angles: int = 1801,
                           compute_intensity_tables: bool = False,
                           hybrid_width_deg: float = 0.0
                           ) -> Optional[OpticalDomain]:
    """Bin li's compact separable domain in O(nz) host work, on the grid's
    device.

    Equivalent to components_from_ssp + build_domain(
    device_fields='compact') for this bin; no 3D array is built or checked
    (the plan already proved the lambda-independent structure). A zero
    cloud-extinction bin builds as gas-only transport (p=0); returns None
    only when the slab would be a total vacuum (the caller falls back to
    the generic build)."""
    nx, ny, nz = grid.shape
    k, ssa_cloud = plan_bin_scalars(plan, li)
    q = plan_gas_profile(plan, li, nz).astype(np.float32)
    if not k > 0.0:
        # zero cloud extinction at this bin: p = 0 (gas-only transport),
        # unless the in-slab majorant would be 0 too (a vacuum slab)
        k = 0.0
        slab_q = q[plan.zb:plan.zt]
        if slab_q.size == 0 or not float(slab_q.max()) > 0.0:
            return None
    p = (plan.mprof * k).astype(np.float32)

    # per-lambda phase tables, flattened in component order
    cloud_tbl = particle_phase_table(plan.cloud, li)
    phase_tables = []
    for kind in plan.comp_kinds:
        if kind == "gas":
            phase_tables.append(PhaseFunctionTable(
                [PhaseFunction.isotropic()], key=[0.0],
                description="Molecular Absorption"))
        else:
            phase_tables.append(cloud_tbl)
    tables = stack_phase_tables(phase_tables, n_cdf_steps, n_forward_angles,
                                compute_intensity_tables, hybrid_width_deg)
    all_hg = all(pf.hg_g is not None
                 for tbl in phase_tables for pf in tbl.phase_functions)
    sep = sep_fields(
        plan.amp, p, q, plan.zb, plan.zt, plan.amp_blockmax, ssa_cloud,
        cloud_tbl.phase_functions[plan.entry].hg_g,
        plan.cloud_offset + plan.entry, plan.tz, float(lambda_um),
        dz_km=plan.dz_km, amp_sum=plan.amp_sum)
    ncomp = len(plan.comp_kinds)
    xe, ye, ze = grid.edges_f32()
    return domain_from_numpy(dict(
        x_edges=xe, y_edges=ye, z_edges=ze, xy_regular=grid.xy_regular,
        z_regular=grid.z_regular, **tables, **sep, all_hg=all_hg,
        # scalar ssa / single entry by construction (the compact build
        # computes these flags only for 1-component domains)
        uniform_ssa=(ncomp == 1), uniform_hg=(ncomp == 1),
        macro_factor=plan.macro_factor, lambda_um=float(lambda_um),
        ncomp_hint=ncomp), device=grid.device)
