"""The optical domain: per-cell solver arrays + stacked phase tables.

PyTorch counterpart of ``mcbrat3d_tpu.domain.domain`` (reference:
src/opticalProperties.f95:63-142). ``build_domain`` flattens the components
on the host in float64 NumPy, exactly as the JAX package does, and places
the float32 results on the grid's device, so both packages see
bit-identical records for the same inputs.

Covered here: ``device_fields="full"`` with the packed ``cell_records``
layout, the two-level macro-cell majorant, the ``uniform_ssa`` /
``uniform_hg`` flags, the radiance (forward / hybrid) phase tables, the
column-template detection, one component or a cloud over a horizontally
uniform pure-absorber gas (the gas template), with its xy-block majorant
table (the column kernel's inputs), and the separable-template detection
with its bf16-bumped block ceilings and separable emission tables (the
separable kernel's inputs), also as a ``device_fields="compact"`` domain
that carries only those. The column emission tables belong to a part of
the column kernel that is not ported yet (its eligibility names it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.physics.hybrid import hybrid_phase_values
from mcbrat3d_tpu_torch.physics.inverse_cdf import inverse_cdf_table
from mcbrat3d_tpu_torch.physics.phase_function import (PhaseFunctionTable,
                                                       forward_tabulate)


@dataclasses.dataclass
class OpticalComponent:
    """One optical component (cloud, aerosol, gas, Rayleigh...).

    ``extinction``/``single_scattering_albedo``/``phase_function_index`` are
    [nx, ny, nzc] or [1, 1, nzc] (horizontally uniform, spread at flatten
    time; reference: src/opticalProperties.f95:1033-1043). ``z_level_base``
    is the 0-based z index of the first occupied level
    (reference: addOpticalComponent, src/opticalProperties.f95:557-730).
    Phase-function indices are 0-based into ``phase_function_table``.
    """

    name: str
    extinction: np.ndarray
    single_scattering_albedo: np.ndarray
    phase_function_index: np.ndarray
    phase_function_table: PhaseFunctionTable
    z_level_base: int = 0

    def __post_init__(self):
        self.extinction = np.atleast_3d(np.asarray(self.extinction, np.float64))
        self.single_scattering_albedo = np.atleast_3d(
            np.asarray(self.single_scattering_albedo, np.float64))
        self.phase_function_index = np.atleast_3d(
            np.asarray(self.phase_function_index, np.int32))
        if not (self.extinction.shape == self.single_scattering_albedo.shape
                == self.phase_function_index.shape):
            raise ValueError(f"component '{self.name}': field shapes disagree")
        if np.any(self.extinction < 0):
            raise ValueError(f"component '{self.name}': negative extinction")
        if (np.any(self.single_scattering_albedo < 0)
                or np.any(self.single_scattering_albedo > 1)):
            raise ValueError(f"component '{self.name}': SSA outside [0,1]")
        n = self.phase_function_table.n_entries
        if (np.any(self.phase_function_index < 0)
                or np.any(self.phase_function_index >= n)):
            raise ValueError(f"component '{self.name}': phase index out of range")

    @property
    def is_horizontally_uniform(self) -> bool:
        return self.extinction.shape[0] == 1 and self.extinction.shape[1] == 1


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Stacked phase-function matrices on the device.

    ``inverse``: [total_entries, n_cdf_steps] scattering angle vs CDF.
    ``forward``: [total_entries, n_forward_angles] phase values on a
    uniform angle grid for local estimation (hybridized when a hybrid
    width is given), or [total_entries, 1] zeros without radiance tables.
    ``forward_orig``: the same before hybridization.
    ``offsets``: [ncomp] row offset of each component's table.
    """

    inverse: torch.Tensor
    forward: torch.Tensor
    forward_orig: torch.Tensor
    offsets: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OpticalDomain:
    """Flattened domain consumed by the transport kernel.

    ``cell_records`` packs everything a collision needs into one row, with
    C = ncomp:
      [0]              total extinction
      [1]              local majorant: max extinction over the cell's
                       macro-cell neighborhood (the global max when
                       macro_factor=0)
      [2        : 2+C] fractional cumulative extinction per component
      [2 + C    : 2+2C] single-scattering albedo per component
      [2 + 2C   : 2+3C] phase-function index per component (as float)
      [2 + 3C   : 2+4C] HG asymmetry g per component's active entry
    """

    grid: Grid
    # the per-cell fields are None on a compact domain
    total_ext: Optional[torch.Tensor]     # [nx, ny, nz] f32
    cum_ext: Optional[torch.Tensor]       # [nx, ny, nz, ncomp] f32
    ssa: Optional[torch.Tensor]           # [nx, ny, nz, ncomp] f32
    phase_index: Optional[torch.Tensor]   # [nx, ny, nz, ncomp] i32
    cell_records: Optional[torch.Tensor]  # [nx*ny*nz, 2 + 4*ncomp] f32
    tables: DeviceTables
    all_hg: bool = False
    uniform_ssa: bool = False
    uniform_hg: bool = False
    macro_factor: int = 0
    temps: Optional[torch.Tensor] = None
    lambda_um: float = 0.0
    # Column-template structure (one component; detected on the float32
    # total extinction): beta(x, y, z) = col_scale[ix*ny+iy] *
    # (iz < col_height[ix*ny+iy]), the shape of Landsat-style scenes
    # (reference: Domain-Files/i3rcLandsatCloud.f95:82-90). With
    # macro_factor > 0, macro_table [nbx*nby, 2] holds each xy block's
    # majorant scale (rounded up to bfloat16, as the JAX package stores it)
    # and its highest cloud top in cells.
    col_template: bool = False
    col_scale: Optional[torch.Tensor] = None    # [nx*ny] f32
    col_height: Optional[torch.Tensor] = None   # [nx*ny] f32, cells from z=0
    macro_table: Optional[torch.Tensor] = None  # [nbx*nby, 2] f32
    # The gas template (two components): the column fields describe the
    # cloud component alone and a horizontally uniform pure absorber adds
    # col_qz[iz]; col_cloud holds (cloud ssa, cloud HG g or 0, max col_qz),
    # and the cloud scatters by analytic HG (col_analytic_hg) or by row
    # col_inv_row of tables.inverse.
    col_qz: Optional[torch.Tensor] = None       # [nz] f32
    col_cloud: Optional[np.ndarray] = None      # [3] f32 (host)
    col_analytic_hg: bool = True
    col_inv_row: int = 0
    # Column emission tables (one component with uniform ssa, z-uniform
    # temps and lambda_um > 0): the emission density (1 - ssa) *
    # col_scale[col] * (iz < h[col]) * B(T(z)) factors into a Walker alias
    # over the columns, w[col] = col_scale[col] * Fcum[h[col] - 1]
    # (col_em_prob, col_em_alias, and col_em_halias = h[alias[col]]), and a
    # level drawn by inverting the cumulative Planck table col_em_fcum
    # truncated at the column's height, z = #{k : Fcum[k] <= u Fcum[h-1]}.
    col_em_prob: Optional[torch.Tensor] = None    # [nx*ny] f32
    col_em_alias: Optional[torch.Tensor] = None   # [nx*ny] f32 column ids
    col_em_halias: Optional[torch.Tensor] = None  # [nx*ny] f32 cells
    col_em_fcum: Optional[torch.Tensor] = None    # [nz] f32
    # Separable-template structure (two components at most; detected on
    # the float32 fields): beta(x, y, z) = sep_amp[ix*ny+iy] * sep_pz[iz]
    # + sep_qz[iz], a rank-1 scattering "cloud" over a horizontally
    # uniform pure absorber, the shape of the reference's broadband-LW
    # flagship (reference: run/I3RC_bench_LW.deck:45). sep_block holds each
    # xy block's in-slab ceiling (block max amp * max p + max in-slab q,
    # bumped up to bfloat16 as the JAX package stores it); sep_scalars are
    # (ssa_cloud, g_cloud, q max below the slab [sep_zb, sep_zt), q max
    # above it, the largest block ceiling, the largest amplitude).
    sep_template: bool = False
    sep_amp: Optional[torch.Tensor] = None     # [nx*ny] f32
    sep_pz: Optional[torch.Tensor] = None      # [nz] f32
    sep_qz: Optional[torch.Tensor] = None      # [nz] f32
    sep_block: Optional[torch.Tensor] = None   # [nbx*nby] f32
    sep_tz: Optional[torch.Tensor] = None      # [nz] f32 temps (z-uniform)
    sep_scalars: Optional[np.ndarray] = None   # [6] f32 (host)
    sep_zb: int = 0
    sep_zt: int = 0
    # the cloud scatters by analytic HG (g = sep_scalars[1]) or by row
    # sep_inv_row of tables.inverse
    sep_analytic_hg: bool = False
    sep_inv_row: int = 0
    sep_tz_uniform: bool = False
    # Separable emission tables (z-uniform temps and lambda_um > 0): the
    # emission density kabs * B(T(z)) = a[col] * P1[z] + Q1[z] with
    # P1 = p (1 - ssa_cloud) B, Q1 = q B; sep_em_zpa holds the Walker z
    # aliases of P1 and Q1 (cloud prob, cloud alias, gas prob, gas alias),
    # sep_em_pb the probability of the cloud branch and sep_em_atm the
    # total atmospheric emission in emission_weighting's units. The column
    # is drawn by the kernel's group-rejection sampler over the host copy
    # sep_amp_np (float64), so no per-column alias is kept.
    sep_em_zpa: Optional[torch.Tensor] = None  # [4, nz] f32
    sep_em_pb: Optional[np.ndarray] = None     # [1] f32 (host)
    sep_em_atm: float = 0.0
    sep_amp_np: Optional[np.ndarray] = None    # [nx*ny] f64 (host)
    # component count of a compact domain (no per-cell fields)
    ncomp_hint: int = 0

    @property
    def n_components(self) -> int:
        if self.cum_ext is not None:
            return self.cum_ext.shape[-1]
        return self.ncomp_hint

    @property
    def device(self) -> torch.device:
        return self.grid.device

    @property
    def max_extinction(self) -> float:
        """Global majorant (float32 max of total extinction, as a float)."""
        return float(torch.max(self.total_ext))


def multi_component_records(domain: OpticalDomain) -> torch.Tensor:
    """The record kernel's per-cell record of a 2-3 component domain:
    [n_cells, 8] float32, on the domain's device, built once per domain.

    Columns: total extinction, local majorant, effective ssa
    (sum_c frac_c * ssa_c), the cumulative scattering fractions cs_0, cs_1
    (0 with two components; 1 in cells that do not scatter), and f2 per
    component (0 for a missing third): its HG g on an all-HG domain, else
    its global stacked phase row ``phase index + tables.offsets[c]``. The
    values of ``pallas_kernel._pack_tables`` (scattering-coefficient
    formulation), computed in float32 in its order: the extinction
    fractions by differences of the cumulative fractions, ``frac * ssa``,
    their sum, then the running sums over max(ssa_eff, 1e-30). Rows are 32
    bytes, so the kernel reads a record as two aligned float4 loads."""
    cache = domain.__dict__
    if "_multi_component_records" not in cache:
        c = domain.n_components
        if not 2 <= c <= 3 or domain.cell_records is None:
            raise ValueError("multi-component records need the per-cell "
                             "records of a domain of 2 or 3 components "
                             f"(this one has {c})")
        rec = domain.cell_records.cpu().numpy()
        cumf = rec[:, 2:2 + c]
        frac = np.diff(cumf, axis=1, prepend=np.float32(0.0))
        scat = frac * rec[:, 2 + c:2 + 2 * c]
        ssa_eff = scat[:, 0] + scat[:, 1]
        if c == 3:
            ssa_eff = ssa_eff + scat[:, 2]
        cs = (np.cumsum(scat, axis=1, dtype=np.float32)
              / np.maximum(ssa_eff, np.float32(1e-30))[:, None])
        cs = np.where(ssa_eff[:, None] > 0, cs, np.float32(1.0))
        if domain.all_hg:
            f2 = rec[:, 2 + 3 * c:2 + 4 * c]
        else:
            offs = domain.tables.offsets.cpu().numpy().astype(np.float32)
            f2 = rec[:, 2 + 2 * c:2 + 3 * c] + offs[None, :]
        out = np.zeros((rec.shape[0], 8), np.float32)
        out[:, 0:2] = rec[:, 0:2]
        out[:, 2] = ssa_eff
        out[:, 3:2 + c] = cs[:, :c - 1]
        out[:, 5:5 + c] = f2
        cache["_multi_component_records"] = torch.tensor(
            out, device=domain.device).contiguous()
    return cache["_multi_component_records"]


def stack_phase_tables(phase_tables, n_cdf_steps: int,
                       n_forward_angles: int, compute_intensity_tables: bool,
                       hybrid_width_deg: float) -> dict:
    """The stacked phase tables of ``phase_tables`` (one per component) as
    NumPy arrays under ``domain_from_numpy``'s names: ``inverse`` rows per
    entry, ``forward`` / ``forward_orig`` (zeros [rows, 1] without radiance
    tables) and the per-component row ``offsets`` (port of
    ``domain._build_device_tables``)."""
    inv_list, fwd_list, offsets, row = [], [], [], 0
    for tbl in phase_tables:
        offsets.append(row)
        row += tbl.n_entries
        inv_list.append(inverse_cdf_table(tbl, n_cdf_steps))
        if compute_intensity_tables:
            fwd_list.append(forward_tabulate(tbl, n_forward_angles))
    inverse = np.concatenate(inv_list, axis=0)
    if compute_intensity_tables:
        forward_orig = np.concatenate(fwd_list, axis=0)
        forward = (hybrid_phase_values(
            np.linspace(0.0, np.pi, n_forward_angles), forward_orig,
            hybrid_width_deg) if hybrid_width_deg > 0.0 else forward_orig)
    else:
        forward = forward_orig = np.zeros((row, 1), np.float64)
    return dict(inverse=inverse, forward=forward, forward_orig=forward_orig,
                offsets=np.asarray(offsets, np.int32))


def build_domain(grid: Grid, components: Sequence[OpticalComponent],
                 n_cdf_steps: int = 9001,
                 n_forward_angles: int = 1801,
                 compute_intensity_tables: bool = False,
                 hybrid_width_deg: float = 0.0,
                 temps: Optional[np.ndarray] = None,
                 lambda_um: float = 0.0,
                 macro_factor: int = 0,
                 device_fields: str = "full") -> OpticalDomain:
    """Flatten components into the solver arrays and stack phase tables.

    Same arithmetic as ``mcbrat3d_tpu.domain.domain.build_domain``; arrays
    land on the grid's device. With ``compute_intensity_tables`` the
    forward phase tables are tabulated on ``n_forward_angles`` angles and,
    for ``hybrid_width_deg > 0``, hybridized (reference:
    src/opticalProperties.f95:1872-2050). With ``temps`` (z-uniform) and
    ``lambda_um > 0`` a separable domain, and a one-component column template
    with uniform ssa, also carries its emission tables.

    ``device_fields="compact"`` builds only the separable-template fields
    and the phase tables (the per-cell fields are None): the only kernel
    that runs such a domain is the separable one, and at flagship scale
    the per-cell fields are ~1 GB it never reads. Raises ValueError when
    the domain is not separable.
    """
    if not components:
        raise ValueError("need at least one optical component")
    if device_fields not in ("full", "compact"):
        raise ValueError(f"device_fields={device_fields!r} "
                         "(expected 'full' or 'compact')")
    nx, ny, nz = grid.shape
    ncomp = len(components)

    ext = np.zeros((nx, ny, nz, ncomp), np.float64)
    ssa = np.zeros((nx, ny, nz, ncomp), np.float64)
    pfi = np.zeros((nx, ny, nz, ncomp), np.int32)

    for c, comp in enumerate(components):
        e = comp.extinction
        a = comp.single_scattering_albedo
        p = comp.phase_function_index
        if comp.is_horizontally_uniform:
            e = np.broadcast_to(e, (nx, ny, e.shape[2]))
            a = np.broadcast_to(a, (nx, ny, a.shape[2]))
            p = np.broadcast_to(p, (nx, ny, p.shape[2]))
        z0 = comp.z_level_base
        z1 = z0 + e.shape[2]
        if z1 > nz:
            raise ValueError(f"component '{comp.name}' extends past the domain top")
        ext[:, :, z0:z1, c] = e
        ssa[:, :, z0:z1, c] = a
        pfi[:, :, z0:z1, c] = p

    total = ext.sum(axis=-1)

    # --- stacked inverse-CDF (and forward) tables, rows per entry ---
    tables = stack_phase_tables(
        [comp.phase_function_table for comp in components], n_cdf_steps,
        n_forward_angles, compute_intensity_tables, hybrid_width_deg)
    all_hg = all(p.hg_g is not None
                 for comp in components
                 for p in comp.phase_function_table.phase_functions)
    geometry = dict(
        x_edges=grid.edges_f32()[0], y_edges=grid.edges_f32()[1],
        z_edges=grid.edges_f32()[2], xy_regular=grid.xy_regular,
        z_regular=grid.z_regular)
    n_cells = nx * ny * nz

    if device_fields == "compact":
        # uniformity flags from the component arrays (the packed records
        # they normally come from are skipped), then the separable
        # detection and nothing else (domain.py:542-580 of the JAX package)
        occ = total > 0.0
        uniform_ssa = uniform_hg = False
        if ncomp == 1:
            sv = ssa[..., 0][occ] if occ.any() else ssa.flat[:1]
            gs = np.array(
                [pf.hg_g if pf.hg_g is not None else 0.0
                 for pf in components[0].phase_function_table.phase_functions],
                np.float32)
            gv = gs[pfi[..., 0][occ]] if occ.any() else gs[:1]
            uniform_ssa = bool(np.all(sv == sv.flat[0]))
            uniform_hg = bool(np.all(gv == gv.flat[0]))
        sep = detect_separable(grid, components, ext, ssa, pfi,
                               macro_factor, temps, False, float(lambda_um))
        if not sep:
            raise ValueError(
                "build_domain(device_fields='compact') requires a "
                "separable domain (beta = a[col]*p[z] + q[z], one rank-1 "
                "scattering component plus at most one horizontally "
                "uniform pure absorber); this one is not -- rebuild with "
                "device_fields='full'")
        return domain_from_numpy(dict(
            **geometry, **tables, **sep, all_hg=all_hg,
            uniform_ssa=uniform_ssa, uniform_hg=uniform_hg,
            macro_factor=int(macro_factor), lambda_um=float(lambda_um),
            ncomp_hint=ncomp), device=grid.device)

    cum = np.cumsum(ext, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        cum_frac = np.where(
            total[..., None] > 0,
            cum / np.maximum(total[..., None], 1e-300), 1.0)
    cum_frac[..., -1] = 1.0

    # Local majorant field for two-level Woodcock: max extinction over each
    # cell's macro block; a regular grid is required (the kernel computes
    # macro-box faces arithmetically).
    if macro_factor > 0 and not (grid.xy_regular and grid.z_regular):
        macro_factor = 0
    global_max = float(total.max()) if total.size else 0.0
    if macro_factor > 0:
        f = macro_factor
        nbx, nby, nbz = -(-nx // f), -(-ny // f), -(-nz // f)
        tp = np.zeros((nbx * f, nby * f, nbz * f), total.dtype)
        tp[:nx, :ny, :nz] = total
        bm = tp.reshape(nbx, f, nby, f, nbz, f).max(axis=(1, 3, 5))
        majorant = np.repeat(np.repeat(np.repeat(
            bm, f, 0), f, 1), f, 2)[:nx, :ny, :nz]
    else:
        majorant = np.full_like(total, global_max)

    rec = np.zeros((n_cells, 2 + 4 * ncomp), np.float32)
    rec[:, 0] = total.reshape(-1)
    rec[:, 1] = majorant.reshape(-1)
    rec[:, 2:2 + ncomp] = cum_frac.reshape(-1, ncomp)
    rec[:, 2 + ncomp:2 + 2 * ncomp] = ssa.reshape(-1, ncomp)
    rec[:, 2 + 2 * ncomp:2 + 3 * ncomp] = pfi.reshape(-1, ncomp)
    for c, comp in enumerate(components):
        gs = np.array([p.hg_g if p.hg_g is not None else 0.0
                       for p in comp.phase_function_table.phase_functions],
                      np.float32)
        rec[:, 2 + 3 * ncomp + c] = gs[pfi.reshape(-1, ncomp)[:, c]]

    # Uniformity over OCCUPIED cells only (empty cells never scatter)
    occ = rec[:, 0] > 0.0
    ssa0 = rec[occ, 2 + ncomp] if occ.any() else rec[:1, 2 + ncomp]
    g0 = rec[occ, 2 + 3 * ncomp] if occ.any() else rec[:1, 2 + 3 * ncomp]
    uniform_ssa = ncomp == 1 and bool(np.all(ssa0 == ssa0[0]))
    uniform_hg = ncomp == 1 and bool(np.all(g0 == g0[0]))
    if uniform_ssa:
        rec[:, 2 + ncomp] = ssa0[0]
    if uniform_hg:
        rec[:, 2 + 3 * ncomp] = g0[0]

    col = {}
    if grid.xy_regular and grid.z_regular:
        col = detect_column_template(components, ext, ssa, pfi, macro_factor)
    if col and uniform_ssa and temps is not None and float(lambda_um) > 0:
        col.update(column_emission_tables(col["col_scale"],
                                          col["col_height"], temps,
                                          float(lambda_um)))
    sep = detect_separable(grid, components, ext, ssa, pfi, macro_factor,
                           temps, bool(col), float(lambda_um))

    return domain_from_numpy(dict(
        **col, **sep, **geometry, **tables,
        total_ext=total, cum_ext=cum_frac, ssa=ssa, phase_index=pfi,
        cell_records=rec, all_hg=all_hg,
        uniform_ssa=uniform_ssa, uniform_hg=uniform_hg,
        macro_factor=int(macro_factor), temps=temps,
        lambda_um=float(lambda_um)), device=grid.device)


def _round_up_bf16(v: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest even) and, where that
    lands below the value, the value bumped by 1 + 2^-6 and rounded again:
    a bfloat16 majorant that is never below ``v`` (domain.py:724-730 of the
    JAX package, with torch.bfloat16 in place of ml_dtypes)."""
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    b16 = t.to(torch.bfloat16).float()
    bumped = (t * (1.0 + 2.0 ** -6)).to(torch.bfloat16).float()
    return torch.where(b16 < t, bumped, b16).numpy()


def detect_column_template(components, ext: np.ndarray, ssa: np.ndarray,
                           pfi: np.ndarray, macro_factor: int) -> dict:
    """Column-template detection on the float64 component fields
    [nx, ny, nz, ncomp] (port of the JAX ``build_domain`` :633-733), on the
    float32 extinction the kernel sees: one component whose every column is
    one uniform block from z = 0, or the gas template, a cloud component of
    that shape over a horizontally uniform pure absorber. The gas template
    also needs cloud tops that vary (a slab of one height over gas is the
    separable kernel's) and one ssa and one phase entry over the cloud's
    occupied cells. Returns the ``col_*`` / ``macro_table`` fields, empty
    when the domain is not a column template."""
    nx, ny, nz, ncomp = ext.shape
    gas_q = None
    if ncomp == 1:
        cand, cloud_c = np.asarray(ext[..., 0], np.float32), 0
    elif ncomp == 2:
        uni = [bool(np.all(ext[:, :, :, c] == ext[:1, :1, :, c]))
               for c in range(2)]
        if uni[0] == uni[1]:
            return {}
        gas_c, cloud_c = (0, 1) if uni[0] else (1, 0)
        occ_g = ext[..., gas_c] > 0
        if occ_g.any() and float(np.abs(ssa[..., gas_c][occ_g]).max()) != 0:
            return {}
        gas_q = np.asarray(ext[0, 0, :, gas_c], np.float32)
        cand = np.asarray(ext[..., cloud_c], np.float32)
    else:
        return {}
    t2 = cand.reshape(nx * ny, nz)
    h = (t2 > 0.0).sum(axis=1).astype(np.int64)
    iz_row = np.arange(nz)[None, :]
    if not bool(np.all((t2 > 0.0) == (iz_row < h[:, None]))):
        return {}
    scale = t2[np.arange(nx * ny), np.maximum(h - 1, 0)]
    scale = np.where(h > 0, scale, 0.0).astype(np.float32)
    if not bool(np.all(t2 == scale[:, None] * (iz_row < h[:, None]))):
        return {}
    out = dict(col_template=True, col_scale=scale,
               col_height=h.astype(np.float32))
    if gas_q is not None:
        occ_c = cand > 0
        if not occ_c.any() or int(h.max()) == int(h[h > 0].min()):
            return {}
        ssa_c = ssa[..., cloud_c][occ_c]
        pfi_c = pfi[..., cloud_c][occ_c]
        if not (bool(np.all(ssa_c == ssa_c.flat[0]))
                and bool(np.all(pfi_c == pfi_c.flat[0]))):
            return {}
        entry = int(pfi_c.flat[0])
        g_c = components[cloud_c].phase_function_table.phase_functions[
            entry].hg_g
        offset = sum(components[c].phase_function_table.n_entries
                     for c in range(cloud_c))
        out.update(
            col_qz=gas_q,
            col_cloud=np.asarray(
                [float(ssa_c.flat[0]), float(g_c) if g_c is not None
                 else 0.0, float(gas_q.max())], np.float32),
            col_analytic_hg=g_c is not None, col_inv_row=offset + entry)
    if macro_factor > 0:
        # per xy block: the cloud's majorant scale (rounded up to bfloat16)
        # and its highest cloud top; blocks span the full z range
        f = macro_factor
        nbx, nby = -(-nx // f), -(-ny // f)
        s2 = np.zeros((nbx * f, nby * f), np.float32)
        h2 = np.zeros((nbx * f, nby * f), np.float32)
        s2[:nx, :ny] = scale.reshape(nx, ny)
        h2[:nx, :ny] = h.reshape(nx, ny).astype(np.float32)
        bs = s2.reshape(nbx, f, nby, f).max(axis=(1, 3))
        bh = h2.reshape(nbx, f, nby, f).max(axis=(1, 3))
        out["macro_table"] = np.stack(
            [_round_up_bf16(bs).reshape(-1), bh.reshape(-1)], 1)
    return out


def column_emission_tables(scale: np.ndarray, height: np.ndarray, temps,
                           lambda_um: float) -> dict:
    """The ``col_em_*`` tables of a column template with z-uniform
    ``temps`` [nx, ny, nz] (port of the JAX ``build_domain`` :735-761;
    empty when the temperatures vary across columns or nothing emits).
    Reference sampling being replaced: the 3-level CDF scan of
    src/monteCarloIllumination.f95:495-498."""
    from mcbrat3d_tpu_torch.core.planck import planck_radiance
    from mcbrat3d_tpu_torch.sources.illumination import walker_alias

    t = np.asarray(temps)
    if not bool(np.all(t == t[0:1, 0:1, :])):
        return {}
    tz = t[0, 0, :].astype(np.float64)
    b = np.where(tz > 0, planck_radiance(lambda_um, np.maximum(tz, 1.0)),
                 0.0)
    fcum = np.cumsum(b)
    h = np.asarray(height).astype(np.int64)
    wcol = np.asarray(scale, np.float64) * np.where(
        h > 0, fcum[np.maximum(h - 1, 0)], 0.0)
    ws = wcol.sum()
    if not ws > 0:
        return {}
    prob, alias = walker_alias(wcol / ws)
    return dict(col_em_prob=prob.astype(np.float32),
                col_em_alias=alias.astype(np.float32),
                col_em_halias=h[alias].astype(np.float32),
                col_em_fcum=fcum.astype(np.float32))


def sep_blockmax(a: np.ndarray, nx: int, ny: int,
                 macro_factor: int) -> np.ndarray:
    """Per-xy-macro-block max of the column amplitude field [nbx, nby]
    (one block without a macro factor)."""
    f = macro_factor if macro_factor > 0 else max(nx, ny)
    nbx, nby = -(-nx // f), -(-ny // f)
    a2 = np.zeros((nbx * f, nby * f), np.float32)
    a2[:nx, :ny] = a
    return a2.reshape(nbx, f, nby, f).max(axis=(1, 3))


def sep_block_ceiling(blockmax: np.ndarray, pmax: float,
                      qmax_slab: float) -> np.ndarray:
    """In-slab extinction ceiling per block, computed in float32 as the JAX
    package does and bumped up to bfloat16 so that the stored bound never
    falls below the true one (``domain._sep_block_ceiling``)."""
    return _round_up_bf16(blockmax * pmax + qmax_slab)


def sep_emission_tables(p: np.ndarray, q: np.ndarray, tz: np.ndarray,
                        amp_sum: float, ssa_cloud: float, lambda_um: float,
                        nxy: int, nz: int, dz_km: float) -> dict:
    """Separable emission tables (see OpticalDomain.sep_em_*; port of
    ``domain._sep_emission_tables`` without its per-column alias, which
    only the JAX kernel's A/B control reads). Reference sampling being
    replaced: the 3-level CDF scan of src/monteCarloIllumination.f95:
    495-498."""
    from mcbrat3d_tpu_torch.core.planck import planck_radiance
    from mcbrat3d_tpu_torch.sources.illumination import walker_alias

    b = np.where(tz > 0, planck_radiance(lambda_um, np.maximum(tz, 1.0)),
                 0.0)
    p1 = p * (1.0 - ssa_cloud) * b
    q1 = q * b
    w_cloud = float(amp_sum * p1.sum())
    w_gas = float(nxy * q1.sum())
    tot = w_cloud + w_gas
    pb = w_cloud / tot if tot > 0 else 0.0

    def z_alias(dens):
        s = dens.sum()
        return walker_alias(dens / s if s > 0 else np.full(nz, 1.0 / nz))

    zp_c, za_c = z_alias(p1)
    zp_g, za_g = z_alias(q1)
    return dict(
        sep_em_zpa=np.stack([zp_c, za_c, zp_g, za_g]).astype(np.float32),
        sep_em_pb=np.asarray([pb], np.float32),
        # total atmospheric emission in emission_weighting's units
        # (4 pi B kabs dz summed over the voxels), for the
        # atmosphere/surface split of illumination.emission_separable
        sep_em_atm=4.0 * np.pi * float(dz_km) * tot)


def detect_separable(grid: Grid, components, ext, ssa, pfi,
                     macro_factor: int, temps, col_template: bool,
                     lambda_um: float = 0.0) -> dict:
    """Detect beta = a[x,y] * p[z] + q[z] on the float64 component fields
    [nx, ny, nz, ncomp] (port of ``domain._detect_separable``): the rank-1
    "cloud" component has one phase entry and a uniform ssa over its
    occupied cells; the horizontally uniform "gas" component (if any) is a
    pure absorber. Up to 131,072 columns and 256 levels on a regular grid.
    Returns the ``sep_*`` fields, empty when the domain is not separable."""
    nx, ny, nz = grid.shape
    ncomp = len(components)
    if (col_template or ncomp > 2 or nz > 256 or nx * ny > 131072
            or not (grid.xy_regular and grid.z_regular)):
        return {}
    uniform = [bool(np.all(ext[:, :, :, c] == ext[:1, :1, :, c]))
               for c in range(ncomp)]
    if ncomp == 2:
        if uniform[0] == uniform[1]:
            return {}
        cloud_c, gas_c = (1, 0) if uniform[0] else (0, 1)
    else:
        if uniform[0]:
            return {}
        cloud_c, gas_c = 0, None

    e_c = np.asarray(ext[:, :, :, cloud_c], np.float32)
    occ_c = e_c > 0
    if not occ_c.any():
        return {}
    # the gas must be a pure absorber (else the scattering component would
    # depend on position and the single-phase kernel would be biased)
    if gas_c is not None:
        q = np.asarray(ext[0, 0, :, gas_c], np.float32)
        occ_g = ext[:, :, :, gas_c] > 0
        if occ_g.any() and float(np.abs(ssa[:, :, :, gas_c][occ_g]).max()) > 0:
            return {}
    else:
        q = np.zeros(nz, np.float32)

    # rank-1 factorization from the strongest column
    ij = np.unravel_index(np.argmax(e_c.sum(axis=2)), (nx, ny))
    p = e_c[ij[0], ij[1], :].astype(np.float32)
    zref = int(np.argmax(p))
    if p[zref] <= 0:
        return {}
    a = (e_c[:, :, zref] / p[zref]).astype(np.float32)
    # columns with zero amplitude at zref must be empty columns
    if bool(np.any(occ_c.any(axis=2) & (a <= 0))):
        return {}
    approx = a[:, :, None] * p[None, None, :]
    tol = 4e-6 * float(e_c.max())
    if not bool(np.all(np.abs(e_c - approx) <= tol + 4e-6 * approx)):
        return {}

    # cloud uniformity: one ssa, one phase entry over occupied cells
    ssa_c_vals = ssa[:, :, :, cloud_c][occ_c]
    pfi_c_vals = pfi[:, :, :, cloud_c][occ_c]
    if (not bool(np.all(ssa_c_vals == ssa_c_vals.flat[0]))
            or not bool(np.all(pfi_c_vals == pfi_c_vals.flat[0]))):
        return {}
    ssa_cloud = float(ssa_c_vals.flat[0])
    entry = int(pfi_c_vals.flat[0])
    g_cloud = components[cloud_c].phase_function_table.phase_functions[
        entry].hg_g
    offset = sum(components[c].phase_function_table.n_entries
                 for c in range(cloud_c))

    # slab bounds + region ceilings
    nzp = np.nonzero(p > 0)[0]
    zb, zt = int(nzp[0]), int(nzp[-1]) + 1
    tz = None
    if temps is not None:
        t = np.asarray(temps)
        if bool(np.all(t == t[0:1, 0:1, :])):
            # the emission tables see the float32 temperatures, as in JAX
            tz = t[0, 0, :].astype(np.float32).astype(np.float64)
    ze = grid.edges_np()[2]
    amp = a.reshape(-1)
    return sep_fields(amp, p, q, zb, zt, sep_blockmax(a, nx, ny, macro_factor),
                      ssa_cloud, g_cloud, offset + entry, tz, lambda_um,
                      dz_km=(ze[-1] - ze[0]) / nz,
                      amp_sum=float(amp.astype(np.float64).sum()))


def sep_fields(amp: np.ndarray, p: np.ndarray, q: np.ndarray, zb: int,
               zt: int, blockmax: np.ndarray, ssa_cloud: float, g_cloud,
               inv_row: int, tz, lambda_um: float, dz_km: float,
               amp_sum: float) -> dict:
    """The ``sep_*`` fields of a separable domain from its factors:
    float32 amplitudes [nx*ny], profiles p, q [nz], the slab [zb, zt), the
    per-block amplitude maxima, the cloud's ssa, HG g (None for a
    tabulated phase) and inverse-CDF row, and the z-uniform temperatures
    (None when they vary or are absent); shared by ``detect_separable``
    and the per-bin plan rebuild."""
    nz = p.size
    qmax_below = float(q[:zb].max()) if zb > 0 else 0.0
    qmax_above = float(q[zt:].max()) if zt < nz else 0.0
    qmax_slab = float(q[zb:zt].max())
    bceil16 = sep_block_ceiling(blockmax, float(p.max()), qmax_slab)
    analytic = g_cloud is not None
    out = dict(
        sep_template=True, sep_amp=amp, sep_pz=p, sep_qz=q,
        sep_block=bceil16.reshape(-1),
        sep_tz=(np.zeros(nz, np.float32) if tz is None
                else tz.astype(np.float32)),
        sep_scalars=np.asarray(
            [ssa_cloud, float(g_cloud) if analytic else 0.0, qmax_below,
             qmax_above, float(bceil16.max()), float(amp.max())],
            np.float32),
        sep_zb=zb, sep_zt=zt, sep_analytic_hg=bool(analytic),
        sep_inv_row=int(inv_row), sep_tz_uniform=tz is not None,
        sep_amp_np=amp.astype(np.float64))
    if tz is not None and lambda_um > 0.0:
        out.update(sep_emission_tables(
            p.astype(np.float64), q.astype(np.float64), tz, amp_sum,
            ssa_cloud, float(lambda_um), amp.size, nz, dz_km))
    return out


def domain_from_numpy(arrays: dict, device="cuda") -> OpticalDomain:
    """Build the port's domain from plain arrays.

    ``arrays`` holds the JAX ``OpticalDomain``'s fields as NumPy arrays or
    Python scalars: ``x_edges``/``y_edges``/``z_edges``, ``xy_regular``,
    ``z_regular``, ``total_ext``, ``cum_ext``, ``ssa``, ``phase_index``,
    ``cell_records`` (all five absent for a compact domain, which then
    gives ``ncomp_hint``), ``inverse``, ``forward`` and ``forward_orig``
    (``tables.*``), ``offsets``, ``all_hg``, ``uniform_ssa``,
    ``uniform_hg``, ``macro_factor`` and optionally ``temps``,
    ``lambda_um``, the column-template fields ``col_template``,
    ``col_scale``, ``col_height``, ``macro_table`` and, for the gas
    template, ``col_qz``, ``col_cloud``, ``col_analytic_hg`` and
    ``col_inv_row``, the column emission tables ``col_em_prob``,
    ``col_em_alias``, ``col_em_halias`` and ``col_em_fcum``, and the
    separable
    fields ``sep_*`` (``sep_em_zpa``, ``sep_em_pb`` and ``sep_em_atm`` only
    with emission tables). Float fields are stored as float32, so a JAX
    domain converted here computes on the same data.
    """
    def opt_f32(name):
        v = arrays.get(name)
        return None if v is None else torch.tensor(
            np.asarray(v, np.float32), device=device).contiguous()

    def opt_host(name, dtype):
        v = arrays.get(name)
        return None if v is None else np.asarray(v, dtype)

    xe, ye, ze = (np.asarray(arrays[k], np.float32)
                  for k in ("x_edges", "y_edges", "z_edges"))
    grid = Grid._make(xe, ye, ze, bool(arrays["xy_regular"]),
                      bool(arrays["z_regular"]), device)
    pfi = arrays.get("phase_index")
    return OpticalDomain(
        grid=grid,
        total_ext=opt_f32("total_ext"),
        cum_ext=opt_f32("cum_ext"),
        ssa=opt_f32("ssa"),
        phase_index=None if pfi is None else torch.tensor(
            np.asarray(pfi, np.int32), device=device),
        cell_records=opt_f32("cell_records"),
        tables=DeviceTables(
            inverse=opt_f32("inverse"),
            forward=opt_f32("forward"),
            forward_orig=opt_f32("forward_orig"),
            offsets=torch.tensor(np.asarray(arrays["offsets"], np.int32),
                                 device=device)),
        all_hg=bool(arrays["all_hg"]),
        uniform_ssa=bool(arrays["uniform_ssa"]),
        uniform_hg=bool(arrays["uniform_hg"]),
        macro_factor=int(arrays["macro_factor"]),
        temps=opt_f32("temps"),
        lambda_um=float(arrays.get("lambda_um", 0.0)),
        col_template=bool(arrays.get("col_template", False)),
        col_scale=opt_f32("col_scale"),
        col_height=opt_f32("col_height"),
        macro_table=opt_f32("macro_table"),
        col_qz=opt_f32("col_qz"),
        col_cloud=opt_host("col_cloud", np.float32),
        col_analytic_hg=bool(arrays.get("col_analytic_hg", True)),
        col_inv_row=int(arrays.get("col_inv_row", 0)),
        col_em_prob=opt_f32("col_em_prob"),
        col_em_alias=opt_f32("col_em_alias"),
        col_em_halias=opt_f32("col_em_halias"),
        col_em_fcum=opt_f32("col_em_fcum"),
        sep_template=bool(arrays.get("sep_template", False)),
        sep_amp=opt_f32("sep_amp"),
        sep_pz=opt_f32("sep_pz"),
        sep_qz=opt_f32("sep_qz"),
        sep_block=opt_f32("sep_block"),
        sep_tz=opt_f32("sep_tz"),
        sep_scalars=opt_host("sep_scalars", np.float32),
        sep_zb=int(arrays.get("sep_zb", 0)),
        sep_zt=int(arrays.get("sep_zt", 0)),
        sep_analytic_hg=bool(arrays.get("sep_analytic_hg", False)),
        sep_inv_row=int(arrays.get("sep_inv_row", 0)),
        sep_tz_uniform=bool(arrays.get("sep_tz_uniform", False)),
        sep_em_zpa=opt_f32("sep_em_zpa"),
        sep_em_pb=opt_host("sep_em_pb", np.float32),
        sep_em_atm=float(arrays.get("sep_em_atm", 0.0)),
        sep_amp_np=opt_host("sep_amp_np", np.float64),
        ncomp_hint=int(arrays.get("ncomp_hint", 0)),
    )
