"""The optical domain: per-cell solver arrays + stacked phase tables.

PyTorch counterpart of ``mcbrat3d_tpu.domain.domain`` (reference:
src/opticalProperties.f95:63-142). ``build_domain`` flattens the components
on the host in float64 NumPy, exactly as the JAX package does, and places
the float32 results on the grid's device, so both packages see
bit-identical records for the same inputs.

Covered here: ``device_fields="full"`` with the packed ``cell_records``
layout, the two-level macro-cell majorant and the ``uniform_ssa`` /
``uniform_hg`` flags. The column/separable template detection, compact
domains and the radiance (forward / hybrid) phase tables belong to kernels
that are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mcbrat3d_tpu_torch.core.grid import Grid
from mcbrat3d_tpu_torch.physics.inverse_cdf import inverse_cdf_table
from mcbrat3d_tpu_torch.physics.phase_function import PhaseFunctionTable


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
    ``offsets``: [ncomp] row offset of each component's table.
    """

    inverse: torch.Tensor
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
    ``device_fields="full"``; arrays land on the grid's device.
    """
    del n_forward_angles  # only the radiance tables use it
    if not components:
        raise ValueError("need at least one optical component")
    if device_fields == "compact":
        raise _not_ported("build_domain(device_fields='compact')",
                          "the separable-template kernel (K4)")
    if device_fields != "full":
        raise ValueError(f"device_fields={device_fields!r} "
                         "(expected 'full' or 'compact')")
    if compute_intensity_tables or hybrid_width_deg > 0.0:
        raise _not_ported("forward/hybrid radiance phase tables",
                          "the record kernel's radiance path (K2)")
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

    # --- stacked inverse-CDF table (rows per component entry) ---
    inv_list, offsets, row = [], [], 0
    for comp in components:
        offsets.append(row)
        row += comp.phase_function_table.n_entries
        inv_list.append(inverse_cdf_table(comp.phase_function_table,
                                          n_cdf_steps))
    inverse = np.concatenate(inv_list, axis=0)

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

    return domain_from_numpy(dict(
        x_edges=grid.edges_f32()[0], y_edges=grid.edges_f32()[1],
        z_edges=grid.edges_f32()[2], xy_regular=grid.xy_regular,
        z_regular=grid.z_regular,
        total_ext=total, cum_ext=cum_frac, ssa=ssa, phase_index=pfi,
        cell_records=rec, inverse=inverse,
        offsets=np.asarray(offsets, np.int32), all_hg=all_hg,
        uniform_ssa=uniform_ssa, uniform_hg=uniform_hg,
        macro_factor=int(macro_factor), temps=temps,
        lambda_um=float(lambda_um)), device=grid.device)


def domain_from_numpy(arrays: dict, device="cpu") -> OpticalDomain:
    """Build the port's domain from plain arrays.

    ``arrays`` holds the JAX ``OpticalDomain``'s fields as NumPy arrays or
    Python scalars: ``x_edges``/``y_edges``/``z_edges``, ``xy_regular``,
    ``z_regular``, ``total_ext``, ``cum_ext``, ``ssa``, ``phase_index``,
    ``cell_records``, ``inverse`` (``tables.inverse``), ``offsets``,
    ``all_hg``, ``uniform_ssa``, ``uniform_hg``, ``macro_factor`` and
    optionally ``temps`` and ``lambda_um``. Float fields are stored as
    float32, so a JAX domain converted here computes on the same data.
    """
    def f32(name):
        return torch.tensor(np.asarray(arrays[name], np.float32),
                            device=device)

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
            offsets=torch.tensor(np.asarray(arrays["offsets"], np.int32),
                                 device=device)),
        all_hg=bool(arrays["all_hg"]),
        uniform_ssa=bool(arrays["uniform_ssa"]),
        uniform_hg=bool(arrays["uniform_hg"]),
        macro_factor=int(arrays["macro_factor"]),
        temps=None if temps is None else torch.tensor(
            np.asarray(temps, np.float32), device=device),
        lambda_um=float(arrays.get("lambda_um", 0.0)),
    )
