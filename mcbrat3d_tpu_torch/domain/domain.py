"""The optical domain: per-cell solver arrays + stacked phase tables.

PyTorch counterpart of ``mcbrat3d_tpu.domain.domain`` (reference:
src/opticalProperties.f95:63-142). ``build_domain`` flattens the components
on the host in float64 NumPy, exactly as the JAX package does, and places
the float32 results on the grid's device, so both packages see
bit-identical records for the same inputs.

Covered here: ``device_fields="full"`` with the packed ``cell_records``
layout, the two-level macro-cell majorant, the ``uniform_ssa`` /
``uniform_hg`` flags, the radiance (forward / hybrid) phase tables and the
one-component column-template detection with its xy-block majorant table
(the column kernel's inputs). The two-component (cloud + gas) column
template, the column emission tables, the separable template and compact
domains belong to kernels that are not ported yet: such domains get
``col_template=False`` (the column kernel's eligibility names why) or raise
``NotImplementedError``.
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
    total_ext: torch.Tensor     # [nx, ny, nz] f32
    cum_ext: torch.Tensor       # [nx, ny, nz, ncomp] f32
    ssa: torch.Tensor           # [nx, ny, nz, ncomp] f32
    phase_index: torch.Tensor   # [nx, ny, nz, ncomp] i32
    cell_records: torch.Tensor  # [nx*ny*nz, 2 + 4*ncomp] f32
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

    @property
    def n_components(self) -> int:
        return self.cum_ext.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.cell_records.device

    @property
    def max_extinction(self) -> float:
        """Global majorant (float32 max of total extinction, as a float)."""
        return float(torch.max(self.total_ext))


def _not_ported(what: str, where: str):
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet; it arrives with {where} "
        "(see ROADMAP.md)")


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

    Same arithmetic as ``mcbrat3d_tpu.domain.domain.build_domain`` for
    ``device_fields="full"``; arrays land on the grid's device. With
    ``compute_intensity_tables`` the forward phase tables are tabulated on
    ``n_forward_angles`` angles and, for ``hybrid_width_deg > 0``,
    hybridized (reference: src/opticalProperties.f95:1872-2050).
    """
    if not components:
        raise ValueError("need at least one optical component")
    if device_fields == "compact":
        raise _not_ported("build_domain(device_fields='compact')",
                          "the separable-template kernel (K4)")
    if device_fields != "full":
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
    inv_list, fwd_list, offsets, row = [], [], [], 0
    for comp in components:
        offsets.append(row)
        row += comp.phase_function_table.n_entries
        inv_list.append(inverse_cdf_table(comp.phase_function_table,
                                          n_cdf_steps))
        if compute_intensity_tables:
            fwd_list.append(forward_tabulate(comp.phase_function_table,
                                             n_forward_angles))
    inverse = np.concatenate(inv_list, axis=0)
    if compute_intensity_tables:
        forward_orig = np.concatenate(fwd_list, axis=0)
        forward = (hybrid_phase_values(
            np.linspace(0.0, np.pi, n_forward_angles), forward_orig,
            hybrid_width_deg) if hybrid_width_deg > 0.0 else forward_orig)
    else:
        forward = forward_orig = np.zeros((row, 1), np.float64)

    all_hg = all(p.hg_g is not None
                 for comp in components
                 for p in comp.phase_function_table.phase_functions)
    n_cells = nx * ny * nz

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
    if ncomp == 1 and grid.xy_regular and grid.z_regular:
        col = detect_column_template(np.asarray(total, np.float32),
                                     macro_factor)

    return domain_from_numpy(dict(
        **col,
        x_edges=grid.edges_f32()[0], y_edges=grid.edges_f32()[1],
        z_edges=grid.edges_f32()[2], xy_regular=grid.xy_regular,
        z_regular=grid.z_regular,
        total_ext=total, cum_ext=cum_frac, ssa=ssa, phase_index=pfi,
        cell_records=rec, inverse=inverse, forward=forward,
        forward_orig=forward_orig, offsets=np.asarray(offsets, np.int32), all_hg=all_hg,
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


def detect_column_template(total: np.ndarray, macro_factor: int) -> dict:
    """One-component column-template detection on the float32 total
    extinction [nx, ny, nz] (port of the JAX ``build_domain``
    :633-733 for one component): every column is one uniform block from
    z = 0. Returns the ``col_*`` / ``macro_table`` fields, empty when the
    field is not a column template."""
    nx, ny, nz = total.shape
    t2 = total.reshape(nx * ny, nz)
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
    if macro_factor > 0:
        # per xy block: the majorant scale (rounded up to bfloat16) and the
        # highest cloud top; blocks span the full z range
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


def domain_from_numpy(arrays: dict, device="cpu") -> OpticalDomain:
    """Build the port's domain from plain arrays.

    ``arrays`` holds the JAX ``OpticalDomain``'s fields as NumPy arrays or
    Python scalars: ``x_edges``/``y_edges``/``z_edges``, ``xy_regular``,
    ``z_regular``, ``total_ext``, ``cum_ext``, ``ssa``, ``phase_index``,
    ``cell_records``, ``inverse``, ``forward`` and ``forward_orig``
    (``tables.*``), ``offsets``, ``all_hg``, ``uniform_ssa``,
    ``uniform_hg``, ``macro_factor`` and optionally ``temps``,
    ``lambda_um`` and the column-template fields ``col_template``,
    ``col_scale``, ``col_height`` and ``macro_table``. Float fields are
    stored as float32, so a JAX domain converted here computes on the same
    data.
    """
    def f32(name):
        return torch.tensor(np.asarray(arrays[name], np.float32),
                            device=device)

    def opt_f32(name):
        v = arrays.get(name)
        return None if v is None else torch.tensor(
            np.asarray(v, np.float32), device=device).contiguous()

    xe, ye, ze = (np.asarray(arrays[k], np.float32)
                  for k in ("x_edges", "y_edges", "z_edges"))
    grid = Grid._make(xe, ye, ze, bool(arrays["xy_regular"]),
                      bool(arrays["z_regular"]), device)
    temps = arrays.get("temps")
    return OpticalDomain(
        grid=grid,
        total_ext=f32("total_ext"),
        cum_ext=f32("cum_ext"),
        ssa=f32("ssa"),
        phase_index=torch.tensor(
            np.asarray(arrays["phase_index"], np.int32), device=device),
        cell_records=f32("cell_records").contiguous(),
        tables=DeviceTables(
            inverse=f32("inverse").contiguous(),
            forward=f32("forward").contiguous(),
            forward_orig=f32("forward_orig").contiguous(),
            offsets=torch.tensor(np.asarray(arrays["offsets"], np.int32),
                                 device=device)),
        all_hg=bool(arrays["all_hg"]),
        uniform_ssa=bool(arrays["uniform_ssa"]),
        uniform_hg=bool(arrays["uniform_hg"]),
        macro_factor=int(arrays["macro_factor"]),
        temps=None if temps is None else torch.tensor(
            np.asarray(temps, np.float32), device=device),
        lambda_um=float(arrays.get("lambda_um", 0.0)),
        col_template=bool(arrays.get("col_template", False)),
        col_scale=opt_f32("col_scale"),
        col_height=opt_f32("col_height"),
        macro_table=opt_f32("macro_table"),
    )
